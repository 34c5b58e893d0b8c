"""KITTI multimodal dataset (LiDAR + virtual points).

The port's copy of ``virconv_tpu/datasets/kitti/kitti_dataset_mm.py``:
8-feature ``velodyne_depth/*.npy`` points (x, y, z, intensity, r, g, b,
indicator), the camera field-of-view crop, info generation
(``get_infos``), the gt database of the training split
(``create_groundtruth_database``: ``gt_database_mm/*.bin`` and
``kitti_dbinfos_train_mm.pkl``), the KITTI-format prediction dicts with
host WBF and the small-box height fix (+2 px below 25 px). Training
samples rename Van to Car under ``USE_VAN``, keep the gt boxes with LiDAR
points inside, carry the road plane for the gt sampler, and an index whose
sample is left without gt boxes is replaced by a random one (drawn from
the dataset's ``RandomState``). Image sizes are read from the PNG header,
so no image library is needed.

Infos and the gt database of a KITTI tree:

    python -m virconv_tpu_torch.datasets.kitti.kitti_dataset_mm \\
        create_kitti_infos virconv_t <kitti root>
"""

from __future__ import annotations

import concurrent.futures as futures
import copy
import pickle
import struct
from pathlib import Path

import numpy as np

from ...ops import boxes_np
from ...ops.wbf import compute_wbf
from ...utils import common as common_utils
from ...utils.calibration import Calibration
from ..dataset import LIDAR, DatasetTemplate
from . import kitti_utils

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def png_shape(path):
    """(height, width) int32 from a PNG file's IHDR chunk."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: not a PNG file')
    width, height = struct.unpack('>II', head[16:24])
    return np.array([height, width], dtype=np.int32)


class KittiDatasetMM(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=False,
                 root_path=None, logger=None, seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path,
                         logger=logger, seed=seed)
        self.set_split(self.dataset_cfg.DATA_SPLIT[self.mode])
        self.kitti_infos = []
        self.include_kitti_data()

    def include_kitti_data(self):
        """Load the infos of ``INFO_PATH[mode]``."""
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[self.mode]:
            path = self.root_path / info_path
            if path.exists():
                with open(path, 'rb') as f:
                    infos.extend(pickle.load(f))
        self.kitti_infos.extend(infos)
        if self.logger is not None:
            self.logger.info(
                f'Loaded {len(infos)} KITTI infos for {self.mode}')

    def set_split(self, split):
        self.split = split
        self.root_split_path = self.root_path / (
            'training' if split != 'test' else 'testing')
        split_file = self.root_path / 'ImageSets' / (split + '.txt')
        self.sample_id_list = [x.strip() for x in open(split_file)
                               if x.strip()] if split_file.exists() else None

    # ------------------------------------------------------- raw access -----
    def frame_root(self, info):
        """The directory that holds the raw data of ``info``'s frame."""
        return self.root_split_path

    def get_lidar(self, idx):
        f = self.root_split_path / 'velodyne' / f'{idx}.bin'
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 4)

    def get_lidar_mm(self, idx, root=None):
        root = self.root_split_path if root is None else root
        f = root / self.dataset_cfg.MM_PATH / f'{idx}.npy'
        return np.load(f).astype(np.float32)

    def get_image_shape(self, idx):
        return png_shape(self.root_split_path / 'image_2' / f'{idx}.png')

    def get_label(self, idx):
        f = self.root_split_path / 'label_2' / f'{idx}.txt'
        return kitti_utils.get_objects_from_label(f)

    def get_calib(self, idx, root=None):
        root = self.root_split_path if root is None else root
        return Calibration(root / 'calib' / f'{idx}.txt')

    def get_road_plane(self, idx, root=None):
        root = self.root_split_path if root is None else root
        f = root / 'planes' / f'{idx}.txt'
        if not f.exists():
            return None
        with open(f, 'r') as fh:
            lines = fh.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        flag = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]))
        return flag & (pts_depth >= 0)

    # ------------------------------------------------- info generation ------
    def _scene_info(self, sample_idx, has_label, count_inside_pts):
        info = {'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                'image': {'image_idx': sample_idx,
                          'image_shape': self.get_image_shape(sample_idx)}}
        calib = self.get_calib(sample_idx)
        bottom = np.array([[0., 0., 0., 1.]])
        r0 = np.zeros((4, 4), dtype=calib.R0.dtype)
        r0[3, 3] = 1.0
        r0[:3, :3] = calib.R0
        info['calib'] = {'P2': np.concatenate([calib.P2, bottom], 0),
                         'R0_rect': r0,
                         'Tr_velo_to_cam': np.concatenate([calib.V2C,
                                                           bottom], 0)}
        if not has_label:
            return info
        objs = self.get_label(sample_idx)
        annos = {
            'name': np.array([o.cls_type for o in objs]),
            'truncated': np.array([o.truncation for o in objs]),
            'occluded': np.array([o.occlusion for o in objs]),
            'alpha': np.array([o.alpha for o in objs]),
            'bbox': np.stack([o.box2d for o in objs]) if objs
            else np.zeros((0, 4)),
            'dimensions': np.array([[o.l, o.h, o.w]
                                    for o in objs]).reshape(-1, 3),
            'location': np.stack([o.loc for o in objs]) if objs
            else np.zeros((0, 3)),
            'rotation_y': np.array([o.ry for o in objs]),
            'score': np.array([o.score for o in objs]),
            'difficulty': np.array([o.level for o in objs], np.int32),
        }
        num_objects = len([o for o in objs if o.cls_type != 'DontCare'])
        num_gt = len(annos['name'])
        annos['index'] = np.array(
            list(range(num_objects)) + [-1] * (num_gt - num_objects),
            np.int32)
        cam = np.concatenate([annos['location'][:num_objects],
                              annos['dimensions'][:num_objects],
                              annos['rotation_y'][:num_objects, None]],
                             axis=1)
        annos['gt_boxes_lidar'] = kitti_utils.boxes3d_kitti_camera_to_lidar(
            cam.astype(np.float32), calib)
        info['annos'] = annos
        num_in = -np.ones(num_gt, np.int32)
        if count_inside_pts and num_objects > 0:
            points = self.get_lidar(sample_idx)
            fov = self.get_fov_flag(calib.lidar_to_rect(points[:, 0:3]),
                                    info['image']['image_shape'], calib)
            idx = boxes_np.points_in_boxes(points[fov][:, :3],
                                           annos['gt_boxes_lidar'])
            for k in range(num_objects):
                num_in[k] = (idx == k).sum()
        annos['num_points_in_gt'] = num_in
        return info

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """One info dict per frame of the split (or of ``sample_id_list``):
        image shape, calibration, and with labels the annotations, their
        LiDAR boxes and the FOV LiDAR points inside each box."""
        ids = sample_id_list if sample_id_list is not None \
            else self.sample_id_list
        with futures.ThreadPoolExecutor(num_workers) as ex:
            return list(ex.map(
                lambda i: self._scene_info(i, has_label, count_inside_pts),
                ids))

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Write each labelled object's points (box-centred, all 8
        features) to ``gt_database_mm/<frame>_<name>_<i>.bin`` and their
        records to ``kitti_dbinfos_<split>_mm.pkl``; returns the records by
        class. ``num_points_in_gt`` counts the object's LiDAR points."""
        db_dir = self.root_path / ('gt_database_mm' if split == 'train'
                                   else f'gt_database_{split}_mm')
        db_info_path = self.root_path / f'kitti_dbinfos_{split}_mm.pkl'
        db_dir.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)
        for info in infos:
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar_mm(sample_idx)
            annos = info['annos']
            gt_boxes = annos['gt_boxes_lidar']
            inside = boxes_np.points_in_boxes(points[:, :3], gt_boxes)
            for i in range(gt_boxes.shape[0]):
                name = annos['name'][i]
                filename = f'{sample_idx}_{name}_{i}.bin'
                gt_points = points[inside == i].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.tofile(str(db_dir / filename))
                if used_classes is None or name in used_classes:
                    all_db_infos.setdefault(name, []).append({
                        'name': name,
                        'path': str((db_dir / filename).relative_to(
                            self.root_path)),
                        'image_idx': sample_idx, 'gt_idx': i,
                        'box3d_lidar': gt_boxes[i],
                        'num_points_in_gt': int(
                            (gt_points[:, -1] == LIDAR).sum()),
                        'difficulty': annos['difficulty'][i],
                        'bbox': annos['bbox'][i],
                        'score': annos['score'][i],
                    })
        with open(db_info_path, 'wb') as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos

    # ------------------------------------------------------ predictions -----
    def generate_prediction_dicts(self, batch_meta, pred_dicts, class_names,
                                  output_path=None):
        """KITTI camera-frame annotations of each frame's predictions (after
        WBF when the record asks for it); with ``output_path`` also one
        KITTI ``.txt`` per frame."""
        def template(n):
            return {'name': np.zeros(n), 'truncated': np.zeros(n),
                    'occluded': np.zeros(n), 'alpha': np.zeros(n),
                    'bbox': np.zeros([n, 4]), 'dimensions': np.zeros([n, 3]),
                    'location': np.zeros([n, 3]), 'rotation_y': np.zeros(n),
                    'score': np.zeros(n), 'boxes_lidar': np.zeros([n, 7])}

        annos = []
        for index, box_dict in enumerate(pred_dicts):
            scores = np.asarray(box_dict['pred_scores'])
            boxes = np.asarray(box_dict['pred_boxes'])
            labels = np.asarray(box_dict['pred_labels'])
            if 'WBF' in box_dict:
                labels, scores, boxes = compute_wbf(
                    labels, scores, boxes, iou_thresh=box_dict['IoU'],
                    retain_low=box_dict['RL'],
                    score_thresh=box_dict['SCORE_THRESH'])
            pred = template(scores.shape[0])
            if scores.shape[0] > 0:
                calib = batch_meta['calib'][index]
                image_shape = batch_meta['image_shape'][index]
                cam = kitti_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                img = kitti_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam, calib, image_shape)
                pred['name'] = np.array(class_names)[labels - 1]
                pred['alpha'] = -np.arctan2(-boxes[:, 1], boxes[:, 0]) \
                    + cam[:, 6]
                pred['bbox'] = img
                height = img[:, 3] - img[:, 1]
                pred['bbox'][height < 25, 3] += 2   # small-box height fix
                pred['dimensions'] = cam[:, 3:6]
                pred['location'] = cam[:, 0:3]
                pred['rotation_y'] = cam[:, 6]
                pred['score'] = scores
                pred['boxes_lidar'] = boxes
            pred['frame_id'] = batch_meta['frame_id'][index]
            annos.append(pred)
            if output_path is not None:
                self._write_txt(Path(output_path)
                                / f"{pred['frame_id']}.txt", pred)
        return annos

    @staticmethod
    def _write_txt(path, pred):
        with open(path, 'w') as f:
            for i in range(len(pred['bbox'])):
                bb, loc = pred['bbox'][i], pred['location'][i]
                dims = pred['dimensions'][i]
                print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                      '%.4f %.4f %.4f %.4f %.4f %.4f'
                      % (pred['name'][i], pred['alpha'][i],
                         bb[0], bb[1], bb[2], bb[3], dims[1], dims[2],
                         dims[0], loc[0], loc[1], loc[2],
                         pred['rotation_y'][i], pred['score'][i]), file=f)

    def evaluation(self, det_annos, class_names):
        """(result_str, result_dict) of the official AP(R40) metric against
        the infos' annotations."""
        if not self.kitti_infos or 'annos' not in self.kitti_infos[0]:
            return None, {}
        from .eval import get_official_eval_result
        eval_det = copy.deepcopy(det_annos)
        eval_gt = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        return get_official_eval_result(eval_gt, eval_det, class_names)

    # ---------------------------------------------------------- items -------
    def __len__(self):
        return len(self.kitti_infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']
        root = self.frame_root(info)
        points = self.get_lidar_mm(sample_idx, root)
        calib = self.get_calib(sample_idx, root)
        img_shape = info['image']['image_shape']
        if self.dataset_cfg.FOV_POINTS_ONLY:
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[self.get_fov_flag(pts_rect, img_shape, calib)]

        input_dict = {'points': points, 'frame_id': sample_idx,
                      'calib': calib, 'mm': np.ones((1, 1))}
        if 'annos' in info:
            annos = common_utils.drop_info_with_name(info['annos'],
                                                     name='DontCare')
            gt_names = annos['name']
            if self.dataset_cfg.get('USE_VAN', None) is True \
                    and self.training:
                gt_names = np.array(['Car' if n == 'Van' else n
                                     for n in gt_names])
            cam = np.concatenate([annos['location'], annos['dimensions'],
                                  annos['rotation_y'][..., None]],
                                 axis=1).astype(np.float32)
            gt_boxes = kitti_utils.boxes3d_kitti_camera_to_lidar(cam, calib)
            if self.training and 'num_points_in_gt' in annos:
                nmask = annos['num_points_in_gt'] > 0
                gt_names, gt_boxes = gt_names[nmask], gt_boxes[nmask]
            input_dict['gt_names'] = gt_names
            input_dict['gt_boxes'] = gt_boxes
            plane = self.get_road_plane(sample_idx, root)
            if plane is not None:
                input_dict['road_plane'] = plane

        data_dict = self.prepare_data(input_dict)
        if data_dict is None:            # no gt box left: another sample
            return self.__getitem__(self.rng.randint(len(self)))
        data_dict['image_shape'] = img_shape
        data_dict['calib'] = calib
        return data_dict


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path,
                       workers=4):
    """``kitti_infos_{train,val,test}.pkl`` of the splits that have an
    ``ImageSets`` file, then the gt database of the train split."""
    dataset = KittiDatasetMM(dataset_cfg=dataset_cfg,
                             class_names=class_names, root_path=data_path)
    splits = {'train': 'kitti_infos_train.pkl', 'val': 'kitti_infos_val.pkl',
              'test': 'kitti_infos_test.pkl'}
    for split, fname in splits.items():
        dataset.set_split(split)
        if dataset.sample_id_list is None:
            continue
        has_label = split != 'test'
        infos = dataset.get_infos(num_workers=workers, has_label=has_label,
                                  count_inside_pts=has_label)
        with open(Path(save_path) / fname, 'wb') as f:
            pickle.dump(infos, f)
        print(f'kitti infos {split}: {len(infos)} -> {fname}')
    dataset.set_split('train')
    dataset.create_groundtruth_database(
        info_path=Path(save_path) / 'kitti_infos_train.pkl', split='train')


if __name__ == '__main__':
    import sys
    if len(sys.argv) > 2 and sys.argv[1] == 'create_kitti_infos':
        from ...config import CONFIGS
        cfg = CONFIGS[sys.argv[2]]()
        root = Path(sys.argv[3]) if len(sys.argv) > 3 else Path('data/kitti')
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        create_kitti_infos(cfg.DATA_CONFIG,
                           class_names=['Car', 'Pedestrian', 'Cyclist'],
                           data_path=root, save_path=root)
    else:
        raise SystemExit('usage: python -m virconv_tpu_torch.datasets.kitti.'
                         'kitti_dataset_mm create_kitti_infos <config> '
                         '<kitti root>')
