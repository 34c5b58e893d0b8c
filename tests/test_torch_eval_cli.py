"""``tools/test_gpu.py`` driven in-process on the CPU (``--device cpu``)
over a 2-frame ``mini`` tree with the tiny configuration (registered for
the test beside ``virconv_t``): one checkpoint, then ``--eval_all`` over a
checkpoint directory; without ``--device cpu`` it refuses a missing card."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from test_torch_eval_loop import eval_cfg
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    from virconv_tpu_torch.train.checkpoint import save_checkpoint
    from virconv_tpu_torch.utils.jax_weights import random_init_
    from virconv_tpu_torch.utils.mini_kitti import write_tree
    tmp = tmp_path_factory.mktemp('cli')
    root = write_tree(tmp / 'kitti', 'mini', frames=2, seed=3)
    cfg = eval_cfg(root)
    model = random_init_(VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG), seed=2)
    for epoch in (1, 2):
        save_checkpoint(tmp / 'ckpt', model.state_dict(), epoch)
    return tmp, root, cfg


@pytest.fixture
def cli(tree, monkeypatch):
    import test_gpu
    monkeypatch.setitem(test_gpu.CONFIGS, 'tiny', lambda: tree[2])
    return test_gpu


def test_cli_evaluates_one_checkpoint_on_cpu(tree, cli):
    tmp, root, _ = tree
    out = tmp / 'out_one'
    res = cli.main(['--cfg', 'tiny', '--ckpt',
                    str(tmp / 'ckpt' / 'checkpoint_epoch_2.pth'),
                    '--device', 'cpu', '--save_to_file', '--output_dir',
                    str(out), '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    assert len(res) == 1 and res[0].frames == 1
    assert len(res[0].result_dict) == 9
    assert set(res[0].recalls) == {'recall_0.3', 'recall_0.5',
                                   'recall_0.7'}
    assert (out / 'final_result' / 'data' / '000001.txt').exists()
    log = next(out.glob('log_eval_*.txt')).read_text()
    assert 'sec_per_example' in log and 'recall_0.3' in log


def test_cli_eval_all_polls_the_checkpoint_directory(tree, cli):
    tmp, root, _ = tree
    res = cli.main(['--cfg', 'tiny', '--eval_all', '--ckpt_dir',
                    str(tmp / 'ckpt'), '--max_waiting_mins', '0',
                    '--device', 'cpu', '--output_dir', str(tmp / 'out_all'),
                    '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    assert len(res) == 2 and all(r.frames == 1 for r in res)
    # both checkpoints hold the same weights and the loader the same seed
    assert res[0].result_dict == res[1].result_dict
    assert res[0].recalls == res[1].recalls


def test_cli_refuses_missing_cuda(tree, cli):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    tmp, root, _ = tree
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--cfg', 'tiny', '--ckpt', 'unused.pth', '--output_dir',
                  str(tmp / 'out_cuda')])
    args, _ = cli.parse_args(['--ckpt', 'x.pth'])
    assert args.device == 'cuda' and args.cfg == 'virconv_t'
