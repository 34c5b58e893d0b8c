"""Official KITTI 40-point AP evaluation (host numpy + the native library).

The port's copy of ``virconv_tpu/datasets/kitti/eval.py``, the official
devkit protocol: difficulty filtering by bbox height / occlusion /
truncation, neighbour classes ignored (Van for Car, Person_sitting for
Pedestrian), DontCare regions, greedy score-descending matching per recall
threshold, and AP_R40 = mean precision over 40 recall samples. Rotated
overlaps and the matching loop run in the native library
(``ops/native.py``) when it is loaded, else in numpy.

Box conventions: image bbox [x1, y1, x2, y2]; camera-frame 3D boxes with
location (x, y, z), dimensions (l, h, w), rotation_y; the BEV overlap is
in the camera x-z plane.
"""

from __future__ import annotations

import numpy as np

from ...ops import native as native_ops

MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.30, 0.50]
CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting',
               'truck']
NO_DETECTION = -10 * 9


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D bbox overlap (IoU or IoA depending on criterion)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = area_b * np.ones_like(area_q)
    else:
        denom = np.ones_like(area_b) * area_q
    return inter / np.clip(denom, 1e-9, None)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Rotated BEV overlap of camera boxes [x, z, l, w, ry]-style arrays
    packed as (N, 5) [cx, cz, l, w, ry]."""
    a = np.zeros((boxes.shape[0], 7))
    b = np.zeros((qboxes.shape[0], 7))
    a[:, [0, 1]] = boxes[:, [0, 1]]
    a[:, [3, 4]] = boxes[:, [2, 3]]
    a[:, 5] = 1
    a[:, 6] = -boxes[:, 4]
    b[:, [0, 1]] = qboxes[:, [0, 1]]
    b[:, [3, 4]] = qboxes[:, [2, 3]]
    b[:, 5] = 1
    b[:, 6] = -qboxes[:, 4]
    inter = native_ops.boxes_overlap_bev(a, b)
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = area_a * np.ones_like(area_b)
    else:
        denom = np.ones_like(area_a) * area_b
    return inter / np.clip(denom, 1e-9, None)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D overlap of camera boxes (N, 7) [x, y, z, l, h, w, ry]: rotated
    x-z overlap x y-extent overlap / union. KITTI camera y points down and
    location is the bottom center."""
    a5 = boxes[:, [0, 2, 3, 5, 6]]
    b5 = qboxes[:, [0, 2, 3, 5, 6]]
    a7 = np.zeros((len(boxes), 7))
    b7 = np.zeros((len(qboxes), 7))
    a7[:, [0, 1]] = a5[:, [0, 1]]
    a7[:, [3, 4]] = a5[:, [2, 3]]
    a7[:, 5] = 1
    a7[:, 6] = -a5[:, 4]
    b7[:, [0, 1]] = b5[:, [0, 1]]
    b7[:, [3, 4]] = b5[:, [2, 3]]
    b7[:, 5] = 1
    b7[:, 6] = -b5[:, 4]
    inter_bev = native_ops.boxes_overlap_bev(a7, b7)

    ymax_a = boxes[:, 1][:, None]
    ymin_a = (boxes[:, 1] - boxes[:, 4])[:, None]
    ymax_b = qboxes[:, 1][None, :]
    ymin_b = (qboxes[:, 1] - qboxes[:, 4])[None, :]
    yh = np.clip(np.minimum(ymax_a, ymax_b) - np.maximum(ymin_a, ymin_b),
                 0, None)
    inter = inter_bev * yh
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = vol_a * np.ones_like(vol_b)
    else:
        denom = np.ones_like(vol_a) * vol_b
    return inter / np.clip(denom, 1e-9, None)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        valid_class = -1
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(bbox)
    for i in range(num_dt):
        height = dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1]
        if dt_anno['name'][i].lower() == current_cls_name:
            ignored_dt.append(1 if height < MIN_HEIGHT[difficulty] else 0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """One image's TP/FP/FN under one score threshold (official protocol)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    if native_ops.available():
        dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes)
                                  .reshape(-1, 4), criterion=0) \
            if (metric == 0 and len(dc_bboxes) > 0) else None
        res = native_ops.kitti_compute_statistics(
            overlaps, dt_scores, dt_alphas, gt_alphas,
            np.asarray(ignored_gt), np.asarray(ignored_det), dt_dc,
            metric, min_overlap, thresh, compute_fp, compute_aos)
        if res is not None:
            return res

    assigned = np.zeros(det_size, bool)
    ignored_threshold = dt_scores < thresh if compute_fp \
        else np.zeros(det_size, bool)

    tp = fp = fn = similarity = 0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap \
                    and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif compute_fp and overlap > min_overlap \
                    and (overlap > max_overlap or assigned_ignored_det) \
                    and ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap \
                    and valid_detection == NO_DETECTION \
                    and ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] == -1
                    or ignored_det[j] == 1 or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, np.asarray(dc_bboxes), criterion=0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if ignored_det[j] == -1 or assigned[j] \
                            or ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if tp > 0 or fp > 0 else -1.0
    return tp, fp, fn, similarity, np.asarray(thresholds)


def get_thresholds(scores, num_gt, num_sample_pts=41):
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_dc_num, total_num_valid_gt = [], 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.asarray(ignored_gt, np.int64))
        ignored_dets.append(np.asarray(ignored_det, np.int64))
        dc_bboxes = np.asarray(dc_bboxes).reshape(-1, 4)
        total_dc_num.append(dc_bboxes.shape[0])
        dontcares.append(dc_bboxes)
        total_num_valid_gt += num_valid_gt
        gt_datas = np.concatenate(
            [gt['bbox'], gt['alpha'][..., None]], 1)
        dt_datas = np.concatenate(
            [dt['bbox'], dt['alpha'][..., None], dt['score'][..., None]], 1)
        gt_datas_list.append(gt_datas)
        dt_datas_list.append(dt_datas)
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_dc_num, total_num_valid_gt)


def _calculate_overlaps(gt_annos, dt_annos, metric):
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt['bbox'], gt['bbox'])
        elif metric == 1:
            dt5 = np.concatenate(
                [dt['location'][:, [0, 2]], dt['dimensions'][:, [0, 2]],
                 dt['rotation_y'][..., None]], 1)
            gt5 = np.concatenate(
                [gt['location'][:, [0, 2]], gt['dimensions'][:, [0, 2]],
                 gt['rotation_y'][..., None]], 1)
            o = bev_box_overlap(dt5, gt5)
        else:
            dt7 = np.concatenate(
                [dt['location'], dt['dimensions'],
                 dt['rotation_y'][..., None]], 1)
            gt7 = np.concatenate(
                [gt['location'], gt['dimensions'],
                 gt['rotation_y'][..., None]], 1)
            o = d3_box_overlap(dt7, gt7)
        overlaps.append(o.astype(np.float64))
    return overlaps


_dc_overlap_cache = {}


def _prepare_native(gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
                    dontcares, overlaps, metric):
    """Make the per-image arrays contiguous for the native eval loop and
    cache the detection-vs-DontCare overlaps. Returns False when the native
    library is unavailable (python fallback used instead)."""
    if not native_ops.available():
        return False
    _dc_overlap_cache.clear()
    for i in range(len(gt_datas_list)):
        overlaps[i] = np.ascontiguousarray(overlaps[i], np.float64)
        ignored_gts[i] = np.ascontiguousarray(ignored_gts[i], np.int64)
        ignored_dets[i] = np.ascontiguousarray(ignored_dets[i], np.int64)
        if metric == 0 and len(dontcares[i]) > 0:
            _dc_overlap_cache[i] = np.ascontiguousarray(image_box_overlap(
                dt_datas_list[i][:, :4], dontcares[i], criterion=0),
                np.float64)
        else:
            _dc_overlap_cache[i] = None
    return True


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_sample_pts=41):
    """AP over classes x difficulties x overlap settings."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = _calculate_overlaps(gt_annos, dt_annos, metric)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap,
                          num_sample_pts])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            rets = _prepare_data(gt_annos, dt_annos, current_class,
                                 difficulty)
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_dc_num, total_num_valid_gt) = rets
            for k in range(num_minoverlap):
                min_overlap = min_overlaps[k, metric, m]
                thresholdss = []
                for i in range(len(gt_annos)):
                    tp, fp, fn, sim, th = compute_statistics(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, thresh=0.0,
                        compute_fp=False)
                    thresholdss.append(th)
                thresholdss = np.concatenate(thresholdss)
                thresholds = np.ascontiguousarray(
                    get_thresholds(thresholdss, total_num_valid_gt,
                                   num_sample_pts), np.float64)
                pr = np.zeros([len(thresholds), 4])
                if _prepare_native(gt_datas_list, dt_datas_list,
                                   ignored_gts, ignored_dets, dontcares,
                                   overlaps, metric):
                    for i in range(len(gt_annos)):
                        native_ops.kitti_eval_image_pr(
                            overlaps[i], dt_datas_list[i][:, -1].astype(
                                np.float64),
                            np.ascontiguousarray(dt_datas_list[i][:, 4],
                                                 np.float64),
                            np.ascontiguousarray(gt_datas_list[i][:, 4],
                                                 np.float64),
                            ignored_gts[i], ignored_dets[i],
                            _dc_overlap_cache[i], metric, min_overlap,
                            thresholds, compute_aos, pr)
                else:
                    for i in range(len(gt_annos)):
                        for t, thresh in enumerate(thresholds):
                            tp, fp, fn, sim, _ = compute_statistics(
                                overlaps[i], gt_datas_list[i],
                                dt_datas_list[i], ignored_gts[i],
                                ignored_dets[i], dontcares[i], metric,
                                min_overlap=min_overlap, thresh=thresh,
                                compute_fp=True, compute_aos=compute_aos)
                            pr[t, 0] += tp
                            pr[t, 1] += fp
                            pr[t, 2] += fn
                            if sim != -1:
                                pr[t, 3] += sim
                for t in range(len(thresholds)):
                    recall[m, ld, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 2])
                    precision[m, ld, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 1])
                    if compute_aos:
                        aos[m, ld, k, t] = pr[t, 3] / (pr[t, 0] + pr[t, 1])
                for t in range(len(thresholds)):
                    precision[m, ld, k, t] = np.max(
                        precision[m, ld, k, t:], axis=-1)
                    recall[m, ld, k, t] = np.max(recall[m, ld, k, t:],
                                                 axis=-1)
                    if compute_aos:
                        aos[m, ld, k, t] = np.max(aos[m, ld, k, t:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP_R40(prec):
    sums = prec[..., 1:].sum(-1)
    return sums / 40.0 * 100.0


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    mAP_aos_R40 = get_mAP_R40(ret['orientation']) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    return mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    name_to_class = {v: i for i, v in enumerate(CLASS_NAMES)}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes_int = []
    for cls in current_classes:
        if isinstance(cls, str):
            current_classes_int.append(name_to_class[cls.lower()])
        else:
            current_classes_int.append(cls)
    current_classes = current_classes_int
    min_overlaps = min_overlaps[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break

    result = ''
    ret_dict = {}
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)
    # R40 with the primary (0.7) overlap setting
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_NAMES[curcls].capitalize()
        result += ('%s AP_R40@%.2f:\n' % (cls_name, min_overlaps[0, 0, j]))
        result += 'bbox AP:%.4f, %.4f, %.4f\n' % tuple(mAPbbox[j, :, 0])
        result += 'bev  AP:%.4f, %.4f, %.4f\n' % tuple(mAPbev[j, :, 0])
        result += '3d   AP:%.4f, %.4f, %.4f\n' % tuple(mAP3d[j, :, 0])
        if compute_aos and mAPaos is not None:
            result += 'aos  AP:%.2f, %.2f, %.2f\n' % tuple(mAPaos[j, :, 0])
        for d, diff in enumerate(['easy', 'moderate', 'hard']):
            ret_dict[f'{cls_name}_3d/{diff}_R40'] = mAP3d[j, d, 0]
            ret_dict[f'{cls_name}_bev/{diff}_R40'] = mAPbev[j, d, 0]
            ret_dict[f'{cls_name}_image/{diff}_R40'] = mAPbbox[j, d, 0]
    return result, ret_dict
