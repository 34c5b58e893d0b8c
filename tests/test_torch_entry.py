"""The port's compile-check and multi-rank entry points
(``virconv_tpu_torch/entry.py``) against
``__graft_entry__.py`` and the JAX package's model tests, on the CPU.

(a) The port's small preset (``configs/tiny.small_config``) builds a model
with exactly the parameter and buffer names of the tiny preset ``entry``
builds, and the JAX package's small-preset variables (``jax.eval_shape``
of ``__graft_entry__._tiny_cfg_and_batch(small=True)``'s model) carry
over through ``from_jax_variables`` with no missing or unexpected key and
equal shapes: tests/test_graft_entry.py's guard, across the two packages.
(b) ``utils/bench_inputs.tiny_batch`` gives ``tests/test_model_forward.
make_batch``'s arrays bit for bit. (c) ``dryrun_multichip(4)`` (4 spawned
ranks over gloo, each running ``parallel/spawn.step_rank``) against one
process's ``Trainer`` step on the same 4 entries with the one process's
draws mapped to the ranks (``Draws.for_rank``), held to
tests/test_torch_parallel_step.py's one-process tolerances: the loss
within rel 1e-5, every gradient within 1e-3 x its scale, the ranks'
parameters the same bits. That holds where no capacity cap binds: each
rank sizes its caps from its own entries, one process (and the JAX mesh)
from the whole batch (ROADMAP's known differences). At the dry run's 512
points per entry the strided convs' caps drop rows, in one process and on
the ranks, and keep other rows on the two sides (PERF.md lists that
difference as open), so the equality runs at 80 points per entry (30
valid), where no cap binds in one process or on a rank; the dry run at
its own 512 points is held to what it can keep: a finite loss, the ranks'
parameters the same bits, and the dropped rows shown. (c') Ties the dry
run's preset to the JAX package's: every model and voxelization setting
of ``shrink_cfg(tiny_cfg(mm=True))`` is in ``dryrun_config()`` with the
same value. tests/test_torch_parallel_step.py holds the step of that JAX
preset's settings (dropout off, NMS 256 / 128) on 2 ranks and in one
process against the JAX package's ``make_mesh(2)`` step, on a sparse-grid
batch whose points never share an image pixel. The dry run's own entries
put several valid rows on one pixel, which the two packages resolve
differently (tests/test_torch_train_sparse.py), so a step on them is not
held to JAX at these tolerances. (d) ``entry("cpu")``'s forward returns finite
boxes; without a card every entry point refuses CUDA, and nccl is refused
where it cannot run.
"""
import functools
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _port_shapes(cfg):
    from virconv_tpu_torch.models.detectors.voxel_rcnn import VoxelRCNN
    model = VoxelRCNN(cfg.MODEL, cfg.DATA_CONFIG,
                      num_class=len(cfg.CLASS_NAMES))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith('num_batches_tracked')}


def test_small_preset_has_the_entry_structure_and_takes_jax_variables():
    import jax
    import __graft_entry__ as ge
    from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JRCNN
    from virconv_tpu_torch.configs.tiny import small_config, tiny_config
    from virconv_tpu_torch.utils.jax_weights import from_jax_variables
    small = _port_shapes(small_config())
    assert sorted(small) == sorted(_port_shapes(tiny_config()))
    model_cfg, data_cfg, batch = ge._tiny_cfg_and_batch(
        train=True, n_entries=1, small=True)
    jm = JRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    shapes = jax.eval_shape(
        functools.partial(jm.init, train=True),
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(('params', 'stvd', 'sampling', 'dropout'))},
        jax.tree_util.tree_map(
            lambda x: None if x is None else jax.ShapeDtypeStruct(
                np.shape(x), np.asarray(x).dtype), batch,
            is_leaf=lambda x: x is None))
    variables = {c: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[c])
        for c in ('params', 'batch_stats')}
    got = {k: tuple(v.shape) for k, v in
           from_jax_variables(variables).items()}
    assert sorted(set(small) - set(got)) == []
    assert sorted(set(got) - set(small)) == []
    assert {k: v for k, v in got.items() if v != small[k]} == {}


@pytest.mark.parametrize('seed', [0, 5])
@pytest.mark.parametrize('train', [True, False])
def test_tiny_batch_is_make_batch(seed, train):
    from test_model_forward import make_batch
    from virconv_tpu_torch.utils.bench_inputs import tiny_batch
    kw = dict(n_entries=4, n_pts=700, train=train, n_rep=1 if train else 2)
    want = make_batch(np.random.default_rng(seed), **kw)
    got = tiny_batch(np.random.default_rng(seed), **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def _caps_hold(caps):
    return all(rows <= cap for _, cap, rows in caps)


def _same_params(ranks):
    for r in ranks[1:]:
        for n, p in ranks[0]['params'].items():
            assert torch.equal(p.view(torch.int32),
                               r['params'][n].view(torch.int32)), n


def test_dryrun_on_four_ranks_is_the_one_process_step():
    from test_torch_parallel_step import _grads_close
    from virconv_tpu_torch.entry import (DRYRUN_TOTAL_STEPS, dryrun_config,
                                         dryrun_multichip)
    from virconv_tpu_torch.ops import sparse
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.bench_inputs import tiny_batch
    trainer = Trainer(dryrun_config(), device='cpu', seed=0,
                      total_steps=DRYRUN_TOTAL_STEPS)
    batch = tiny_batch(np.random.default_rng(0), n_entries=4, n_pts=80,
                       train=True)
    draws = Draws(torch.Generator().manual_seed(3))
    sparse.CAP_LOG = []
    try:
        loss, _ = trainer.step(batch, draws)
        assert _caps_hold(sparse.CAP_LOG), sparse.CAP_LOG
    finally:
        sparse.CAP_LOG = None
    loss = float(loss)
    grads = {n: p.grad.clone() for n, p in
             trainer.model.named_parameters() if p.grad is not None}
    got, ranks = dryrun_multichip(4, device='cpu', draws=draws, n_pts=80)
    assert len(ranks) == 4
    assert abs(got - loss) <= 1e-5 * abs(loss), (got, loss)
    for r in ranks:
        assert r['loss'] == got
        _grads_close(r['grads'], grads)
        assert _caps_hold(r['caps']), r['caps']
    _same_params(ranks)


def _jax_keys_equal(want, got, path='MODEL'):
    """Every setting of the JAX config ``want`` is in ``got`` with the same
    value (the port's configs carry more keys, which the JAX one lacks)."""
    if isinstance(want, dict):
        for k, v in want.items():
            assert k in got, f'{path}.{k}'
            _jax_keys_equal(v, got[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _jax_keys_equal(a, b, f'{path}[{i}]')
    else:
        assert want == got, (path, want, got)


def test_dryrun_config_is_the_jax_small_preset():
    from test_model_forward import shrink_cfg, tiny_cfg
    from virconv_tpu_torch.entry import dryrun_config
    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    cfg = dryrun_config()
    _jax_keys_equal(model_cfg, cfg.MODEL)
    _jax_keys_equal(data_cfg.DATA_PROCESSOR, cfg.DATA_CONFIG.DATA_PROCESSOR,
                    'DATA_PROCESSOR')


def test_dryrun_at_its_own_size_keeps_the_ranks_equal():
    from virconv_tpu_torch.entry import (DRYRUN_TOTAL_STEPS, dryrun_batch,
                                         dryrun_config, dropped_rows,
                                         dryrun_multichip)
    from virconv_tpu_torch.ops import sparse
    from virconv_tpu_torch.train.trainer import Trainer
    loss, ranks = dryrun_multichip(4, device='cpu')
    assert np.isfinite(loss) and all(r['loss'] == loss for r in ranks)
    _same_params(ranks)
    assert all(dropped_rows(r['caps']) for r in ranks)
    sparse.CAP_LOG = []
    try:
        Trainer(dryrun_config(), device='cpu', seed=0,
                total_steps=DRYRUN_TOTAL_STEPS).step(dryrun_batch(4))
        one = dropped_rows(sparse.CAP_LOG)
    finally:
        sparse.CAP_LOG = None
    # one process sizes each cap from all 4 entries: 4 x a rank's
    assert one and one[0][1] == 4 * dropped_rows(ranks[0]['caps'])[0][1]


def test_entry_forward_on_cpu_gives_finite_boxes():
    from virconv_tpu_torch.entry import entry
    forward, (model, batch) = entry('cpu')
    assert not model.training
    out = forward(model, batch)
    boxes = out['batch_box_preds']
    assert boxes.shape[0] == 1 and boxes.shape[-1] == 7   # 2 replicas
    assert torch.isfinite(boxes).all()


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from virconv_tpu_torch.entry import dryrun_multichip, entry
    from virconv_tpu_torch.parallel.fullwidth import run_fullwidth
    from virconv_tpu_torch.parallel.spawn import rank_backend
    for call in (entry, lambda: dryrun_multichip(2), lambda: run_fullwidth(2),
                 lambda: rank_backend(2, 'cuda', 'nccl')):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
    cli = runpy.run_path(str(ROOT / 'tools' / 'run_fullwidth_dp_gpu.py'),
                         run_name='imported')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli['main']([])
    assert rank_backend(8, 'cpu') == ('gloo', 'cpu')
    with pytest.raises(ValueError, match='gloo'):
        rank_backend(2, 'cpu', 'nccl')
