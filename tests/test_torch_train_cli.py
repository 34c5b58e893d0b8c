"""``tools/train_gpu.py`` driven in-process on the CPU (``--device cpu``)
with the tiny training configuration (registered for the test beside
``virconv_t``) over a 3-frame ``mini`` tree (2 train frames with their gt
database, 1 val frame): one epoch writes a checkpoint, a second call
resumes at its epoch and step and evaluates the last checkpoint. A
``Trainer`` that saves, is rebuilt and loads the file takes the same next
step as one that was never interrupted, bit for bit. Without
``--device cpu`` the CLI refuses a missing card.

``torch.utils.tensorboard`` is made unimportable while the CLI runs here
(the metrics logger then writes its JSONL events only): where TensorFlow
is installed, that import alone takes longer than the training."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    tmp = tmp_path_factory.mktemp('train_cli')
    root = write_tree(tmp / 'kitti', 'mini', frames=3, seed=3, n_train=2)
    return tmp, root, tiny_train_config(root)


@pytest.fixture
def cli(tree, monkeypatch):
    import train_gpu
    monkeypatch.setitem(train_gpu.CONFIGS, 'tiny', lambda: tree[2])
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    return train_gpu


def test_cli_trains_resumes_and_evaluates_on_cpu(tree, cli):
    from virconv_tpu_torch.train.checkpoint import load_checkpoint
    tmp, root, _ = tree
    out = tmp / 'run'
    argv = ['--cfg', 'tiny', '--batch_size', '2', '--device', 'cpu',
            '--output_dir', str(out), '--log_interval', '1',
            '--fix_random_seed', '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
    first = cli.main(['--epochs', '1', '--no_eval'] + argv)
    assert first.start_epoch == 0 and first.resumed_from is None
    assert [s['step'] for s in first.steps] == [1]
    assert first.eval is None and first.frames == 2
    ckpt1 = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    saved = load_checkpoint(ckpt1)
    assert saved['epoch'] == 1 and saved['step'] == 1
    assert saved['optimizer_state']['count'] == 1

    seen = {}

    def on_start(trainer, start_epoch, resumed_from):
        state = trainer.state_dict()
        seen.update(start_epoch=start_epoch, step=state['step'],
                    resumed_from=resumed_from, lr=trainer.lr(),
                    lr_at_1=float(trainer.optimizer.lr_fn(1)),
                    model=all(torch.equal(v, saved['model_state'][k])
                              for k, v in state['model_state'].items()),
                    mu=all(torch.equal(
                        v, saved['optimizer_state']['mu'][k])
                        for k, v in state['optimizer_state']['mu'].items()))
    second = cli.main(['--epochs', '2'] + argv, on_start=on_start)
    assert seen == {'start_epoch': 1, 'step': 1, 'resumed_from': ckpt1,
                    'lr': seen['lr_at_1'], 'lr_at_1': seen['lr_at_1'],
                    'model': True, 'mu': True}
    assert second.start_epoch == 1 and second.resumed_from == ckpt1
    assert [(s['epoch'], s['step']) for s in second.steps] == [(1, 2)]
    assert all(np.isfinite(s['loss']) and s['nonfinite_skips'] == 0
               for s in first.steps + second.steps)
    assert second.steps[0]['lr'] == seen['lr']
    assert load_checkpoint(out / 'ckpt' / 'checkpoint_epoch_2.pth')[
        'step'] == 2
    res = second.eval
    assert res is not None and res.frames == 1 and len(res.result_dict) == 9
    log = sorted((out / 'log').glob('log_train_*.txt'))[-1].read_text()
    assert 'Resuming from' in log and 'lr ' in log and 'sec_per_example' \
        in log
    events = [json.loads(line) for line in
              (out / 'log' / 'tensorboard' / 'events.jsonl').read_text()
              .splitlines()]
    tags = {e.get('tag') for e in events}
    assert {'train/loss', 'meta_data/learning_rate'} <= tags


def test_resumed_trainer_steps_as_an_uninterrupted_one(tree, tmp_path):
    """Two steps uninterrupted equal one step, a save, a fresh Trainer, a
    load and one step: parameters, BN statistics and optimizer state bit
    for bit."""
    from virconv_tpu_torch.datasets import build_dataloader
    from virconv_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from virconv_tpu_torch.train.trainer import Trainer
    _, _, cfg = tree
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                 seed=2, training=True)
    batches = [b for b, _ in loader]
    assert len(batches) == 2

    def trainer():
        return Trainer(cfg=cfg, device='cpu', seed=5, total_steps=4)
    whole = trainer()
    for b in batches:
        whole.step(b)
    first = trainer()
    first.step(batches[0])
    st = first.state_dict()
    path = save_checkpoint(tmp_path, st['model_state'], 1,
                           st['optimizer_state'], st['step'])
    resumed = trainer()
    resumed.load_state_dict(load_checkpoint(path))
    assert resumed.step_count == 1
    resumed.step(batches[1])
    got, want = resumed.state_dict(), whole.state_dict()
    assert got['step'] == want['step'] == 2
    for k, v in want['model_state'].items():
        assert torch.equal(got['model_state'][k], v), k
    for k, v in want['optimizer_state'].items():
        if isinstance(v, dict):
            assert all(torch.equal(got['optimizer_state'][k][n], t)
                       for n, t in v.items()), k
        else:
            assert got['optimizer_state'][k] == v, k


def test_step_draws_depend_on_seed_and_step_only():
    from virconv_tpu_torch.train.trainer import step_seed
    seeds = {step_seed(s, t) for s in range(3) for t in range(3)}
    assert len(seeds) == 9
    assert step_seed(1, 2) == step_seed(1, 2) < 2 ** 63


def test_cli_refuses_a_weights_only_resume(tree, cli, tmp_path):
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    _, root, cfg = tree
    weights = save_checkpoint(tmp_path / 'w', VoxelRCNN(
        cfg.MODEL, cfg.DATA_CONFIG).state_dict(), 1)
    with pytest.raises(ValueError, match='--pretrained_model'):
        cli.main(['--cfg', 'tiny', '--device', 'cpu', '--ckpt',
                  str(weights), '--output_dir', str(tmp_path / 'out'),
                  '--set', 'DATA_CONFIG.DATA_PATH', str(root)])


def test_cli_refuses_missing_cuda(tree, cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    _, root, _ = tree
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--cfg', 'tiny', '--output_dir', str(tmp_path / 'out'),
                  '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    assert not (tmp_path / 'out').exists()
    args, _ = cli.parse_args([])
    assert args.device == 'cuda' and args.cfg == 'virconv_t'
    assert args.max_ckpt_save_num == 30 and args.log_interval == 50


def test_cli_fine_tunes_s_from_a_t_checkpoint_on_cpu(tmp_path, monkeypatch):
    """VirConv-S's recipe at the tiny widths: ``KittiDatasetSemi`` over the
    ``trainsemi`` split of a tree with 2 train and 1 semi frames, the
    weights of a T checkpoint through ``--pretrained_model``, one epoch in
    batches of 1: the trainer starts from the checkpoint's weights, takes
    one step per frame with finite losses, and reads frames from both
    ``training/`` and ``semi/``."""
    import train_gpu
    from virconv_tpu_torch.configs.tiny import tiny_train_config
    from virconv_tpu_torch.datasets.kitti.kitti_dataset_semi import \
        KittiDatasetSemi
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from virconv_tpu_torch.utils.jax_weights import random_init_
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    root = write_tree(tmp_path / 'kitti', 'mini', frames=3, seed=3,
                      n_train=2, n_semi=1)
    t_cfg = tiny_train_config(root)
    s_cfg = tiny_train_config(root)
    d = s_cfg.DATA_CONFIG
    d.DATASET = 'KittiDatasetSemi'
    d.DATA_SPLIT.train = 'trainsemi'
    d.INFO_PATH.train = ['kitti_infos_trainsemi.pkl']
    t_ckpt = save_checkpoint(tmp_path / 't', random_init_(VoxelRCNN(
        t_cfg.MODEL, t_cfg.DATA_CONFIG), 4).state_dict(), 60)
    monkeypatch.setitem(train_gpu.CONFIGS, 'tiny_s', lambda: s_cfg)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    roots = []
    frame_root = KittiDatasetSemi.frame_root

    def recording(self, info):
        root = frame_root(self, info)
        roots.append(root.name)
        return root
    monkeypatch.setattr(KittiDatasetSemi, 'frame_root', recording)
    start = {}

    def on_start(trainer, start_epoch, resumed_from):
        want = load_checkpoint(t_ckpt)['model_state']
        start['equal'] = all(torch.equal(v, want[k]) for k, v in
                             trainer.model.state_dict().items())
        start['resumed_from'] = resumed_from
    run = train_gpu.main(['--cfg', 'tiny_s', '--batch_size', '1',
                          '--epochs', '1', '--no_eval', '--device', 'cpu',
                          '--pretrained_model', str(t_ckpt),
                          '--output_dir', str(tmp_path / 'run')],
                         on_start=on_start)
    assert start == {'equal': True, 'resumed_from': None}
    assert len(run.steps) == 3 and run.frames == 3
    assert all(np.isfinite(s['loss']) and s['nonfinite_skips'] == 0
               for s in run.steps)
    assert {'training', 'semi'} <= set(roots)


def test_cli_trains_and_evaluates_l_on_cpu(tmp_path, monkeypatch):
    """VirConv-L's structure at the tiny widths through the CLI: the
    single-stream loader, one epoch (2 frames in batches of 1), then the
    evaluation of the last checkpoint on the val frame."""
    import train_gpu
    from virconv_tpu_torch.configs.tiny import tiny_l_train_config
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    root = write_tree(tmp_path / 'kitti', 'mini', frames=3, seed=3,
                      n_train=2)
    cfg = tiny_l_train_config(root)
    monkeypatch.setitem(train_gpu.CONFIGS, 'tiny_l', lambda: cfg)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    run = train_gpu.main(['--cfg', 'tiny_l', '--batch_size', '1',
                          '--epochs', '1', '--device', 'cpu',
                          '--output_dir', str(tmp_path / 'run')])
    assert not run.trainer.model.is_mm
    assert [s['step'] for s in run.steps] == [1, 2]
    assert all(np.isfinite(s['loss']) for s in run.steps)
    assert run.eval is not None and run.eval.frames == 1
    assert len(run.eval.result_dict) == 9
