"""The port's data-parallel training step on 2 spawned ranks (CPU, gloo)
against the JAX package's step on ``make_mesh(2)``, the data-parallel test
of tests/test_multidevice.py: the tiny preset and the sparse-grid batch of
tests/test_torch_train_step.py (2 entries, one per rank), the same carried
weights, the same global batch and the same draws, one ``adam_onecycle``
step of test_multidevice's optimizer settings (JAX's update applied to
the mesh step's gradients outside ``jit``: one compile).

JAX's StVD uniforms and ROI-sampling keys are recorded at run time (debug
callbacks tagged in trace order: ordered callbacks are refused on more
than one device) and replayed to a one-process port step; that step's
draws are mapped to each rank (``Draws.for_rank``: StVD by voxel key, the
sampling draws of the rank's entry, the hard-sampling stripe start to
both). Dropout is off (DP_RATIO 0), as in test_torch_train_step.

Held to test_multidevice.py:140-151's tolerances against the mesh step:
the loss within rel 1e-4, the parameters after the step within 3 x the
first learning rate (rtol 1e-3: Adam turns near-zero gradients into
+/- lr steps) and the BN running statistics within atol 2e-4 / rtol
1e-2; and every gradient within 1e-3 x its scale (floored at 1e-4 x the
step's largest, tests/test_torch_train_step.py's rule). Against the
one-process port step: the loss within rel 1e-5, the gradients as
against JAX, the parameters as above and the BN statistics within 1e-5. The two ranks end with the same parameter
bits, and no capacity cap dropped a row on either rank."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

OPT = {'OPTIMIZER': 'adam_onecycle', 'LR': 0.01, 'WEIGHT_DECAY': 0.01,
       'MOMS': [0.95, 0.85], 'PCT_START': 0.4, 'DIV_FACTOR': 10,
       'GRAD_NORM_CLIP': 10, 'NUM_EPOCHS': 1}
LR0 = OPT['LR'] / OPT['DIV_FACTOR']
TOTAL_STEPS = 10


def install_tagged_recorders(monkeypatch):
    """The StVD uniforms and each stage's ROI-sampling draws of the JAX
    forward, recorded by unordered callbacks under tags taken in trace
    order (test_torch_train_step.install_recorders' draws)."""
    import jax
    from virconv_tpu.models.backbones_3d import virconv as jvirconv
    from virconv_tpu.models.roi_heads import ted_head as jted
    records, tags = {}, [0]
    orig_discard = jvirconv.layer_voxel_discard
    orig_targets = jted.proposal_targets

    def record(draws):
        tag = tags[0]
        tags[0] += 1

        def put(*d):
            records[tag] = [np.asarray(x).astype(
                np.int64 if x.dtype.kind == 'i' else np.float32) for x in d]
        jax.debug.callback(put, *draws)

    def discard(st, rate, rng):
        record([jax.random.uniform(rng, (st.capacity,))])
        return orig_discard(st, rate, rng)

    def targets(rng, rois, roi_scores, roi_labels, gt_boxes, gt_valid, cfg):
        b, r = rois.shape[:2]
        n = int(cfg.ROI_PER_IMAGE)
        keys = jax.random.split(rng, b + 1)
        draws = []
        for i in range(b):
            k1, k2, k3, k4 = jax.random.split(keys[i], 4)
            draws += [jax.random.uniform(k, (r,)) for k in (k1, k2, k3)]
            draws.append(jax.random.randint(k4, (n,), 0, 2 ** 30))
        if cfg.get('ENABLE_HARD_SAMPLING', False):
            teval = int(1 / cfg.HARD_SAMPLING_RATIO[0])
            draws.append(jax.random.randint(keys[b], (), 0, teval))
        record(draws)
        return orig_targets(rng, rois, roi_scores, roi_labels, gt_boxes,
                            gt_valid, cfg)

    monkeypatch.setattr(jvirconv, 'layer_voxel_discard', discard)
    monkeypatch.setattr(jted, 'proposal_targets', targets)
    return records


@pytest.fixture(scope='module')
def runs():
    import jax
    import optax
    from test_model_forward import shrink_cfg, tiny_cfg
    from test_torch_detector import random_variables
    from test_torch_train_step import sparse_grid_batch
    from virconv_tpu.config import CfgNode as JCfg
    from virconv_tpu.models.detectors.voxel_rcnn import VoxelRCNN as JRCNN
    from virconv_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from virconv_tpu.train.optim import build_optimizer
    from virconv_tpu.train.trainer import TrainState
    from virconv_tpu_torch.config import CfgNode, virconv_t_config
    from virconv_tpu_torch.parallel.spawn import run_ranks, step_rank
    from virconv_tpu_torch.train.draws import Draws
    from virconv_tpu_torch.train.trainer import Trainer
    from virconv_tpu_torch.utils.jax_weights import from_jax_variables

    model_cfg, data_cfg = tiny_cfg(mm=True)
    shrink_cfg(model_cfg, data_cfg)
    model_cfg.ROI_HEAD.DP_RATIO = 0.0
    nms = model_cfg.ROI_HEAD.NMS_CONFIG.TRAIN
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 128
    batch = sparse_grid_batch()
    jmodel = JRCNN(model_cfg=model_cfg, dataset_cfg=data_cfg)
    variables = random_variables(jmodel, batch)
    for box in (variables['params']['dense_head']['conv_box'],
                variables['params']['roi_head']['reg_head']['out']):
        box['kernel'] = box['kernel'] * np.float32(0.01)
        box['bias'] = box['bias'] * np.float32(0.01)

    # the JAX package's step on the 2-device mesh
    mesh = make_mesh(2)
    tx, _ = build_optimizer(variables['params'], JCfg(OPT), TOTAL_STEPS)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables['params'])
    state = jax.device_put(TrainState(
        params=params, batch_stats=variables['batch_stats'],
        opt_state=tx.init(params), step=jax.numpy.zeros((), 'int32')),
        replicated(mesh))
    # make_train_step's keys of step 0; value_and_grad under jit on the
    # mesh, then the optimizer's update outside it (one compile, not two)
    rngs = {k: jax.random.fold_in(r, 0) for k, r in zip(
        ('stvd', 'sampling', 'dropout'),
        jax.random.split(jax.random.PRNGKey(7), 3))}
    sharded = shard_batch(batch, mesh)

    def loss_fn(params):
        out, mut = jmodel.apply(
            {'params': params, 'batch_stats': state.batch_stats}, sharded,
            train=True, rngs=rngs, mutable=['batch_stats'])
        return out['loss'], mut['batch_stats']
    with pytest.MonkeyPatch.context() as mp:
        records = install_tagged_recorders(mp)
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(state.params)
        jax.effects_barrier()
    updates, _ = tx.update(jgrads, state.opt_state, state.params)
    want = {'loss': float(jloss),
            'grads': from_jax_variables({'params': jax.device_get(jgrads)}),
            'params': from_jax_variables({'params': jax.device_get(
                optax.apply_updates(state.params, updates))}),
            'stats': from_jax_variables(
                {'params': {}, 'batch_stats': jax.device_get(jstats)})}
    replay = [d for tag in sorted(records) for d in records[tag]]

    # the port: one process on the global batch, then 2 ranks
    opt = virconv_t_config().OPTIMIZATION
    opt.update(OPT)
    cfg = CfgNode({'CLASS_NAMES': ['Car'], 'MODEL': dict(model_cfg),
                   'DATA_CONFIG': dict(data_cfg), 'OPTIMIZATION': opt})
    state_dict = from_jax_variables(variables)
    trainer = Trainer(cfg, state_dict=state_dict, device='cpu',
                      total_steps=TOTAL_STEPS)
    draws = Draws(replay=replay)
    loss, _ = trainer.step(batch, draws)
    assert not draws.replay, 'every JAX draw is used'
    one = {'loss': float(loss),
           'grads': {n: p.grad.clone() for n, p in
                     trainer.model.named_parameters()},
           'params': {n: p.detach().clone() for n, p in
                      trainer.model.named_parameters()},
           'stats': dict(trainer.model.named_buffers())}
    ranks = run_ranks(step_rank, 2, {
        'cfg': cfg, 'state_dict': state_dict, 'batch': batch,
        'device': 'cpu', 'total_steps': TOTAL_STEPS,
        'draws': [draws.for_rank(r, 2) for r in range(2)]}, timeout=300)
    return want, one, ranks


def _params_close(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(np.asarray(got[n], np.float64),
                                   np.asarray(w, np.float64), atol=3 * LR0,
                                   rtol=1e-3, err_msg=n)


def _grads_close(got, want):
    """Each gradient within 1e-3 x its scale, floored at 1e-4 x the step's
    largest (tests/test_torch_train_step.py's rule)."""
    floor = 1e-4 * max(float(g.abs().max()) for g in want.values())
    assert set(got) == set(want)
    for n, g in want.items():
        scale = max(float(g.abs().max()), floor)
        err = float((got[n] - g).abs().max())
        assert err <= 1e-3 * scale, (n, err, scale)


def test_loss_grads_params_and_bn_stats_match_the_jax_mesh_step(runs):
    want, _, ranks = runs
    for r in ranks:
        _grads_close(r['grads'], want['grads'])
        assert abs(r['loss'] - want['loss']) < 1e-4 * max(1.0,
                                                           abs(want['loss']))
        _params_close(r['params'], want['params'])
        for n, w in want['stats'].items():
            np.testing.assert_allclose(r['buffers'][n].numpy(), w.numpy(),
                                       atol=2e-4, rtol=1e-2, err_msg=n)


def test_two_ranks_match_the_one_process_port_step(runs):
    _, one, ranks = runs
    for r in ranks:
        assert abs(r['loss'] - one['loss']) <= 1e-5 * abs(one['loss'])
        _grads_close(r['grads'], one['grads'])
        _params_close(r['params'], one['params'])
        for n, b in one['stats'].items():
            np.testing.assert_allclose(r['buffers'][n].numpy(), b.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=n)


def test_ranks_bit_equal_and_no_cap_dropped_a_row(runs):
    _, _, (r0, r1) = runs
    for n, p in r0['params'].items():
        assert torch.equal(p.view(torch.int32), r1['params'][n].view(
            torch.int32)), n
    for n, b in r0['buffers'].items():
        assert torch.equal(b, r1['buffers'][n]), n
    for r in (r0, r1):
        assert r['caps'] and all(rows <= cap for _, cap, rows in r['caps'])
        assert r['steps'][0]['collectives']['grads']['calls'] == 1
    assert r0['steps'][0]['collectives'] == r1['steps'][0]['collectives']
