"""``VIRCONV_BF16_FEATS`` through the whole VirConv-T eval forward: the
port's ``VoxelRCNN`` (plain kernel versions on the CPU) against the JAX
package's on its band-kernel eval path (Pallas in interpret mode, run
eagerly), one forward of tests/test_torch_detector.py's tiny preset and
batch with the same weights (``detector_runs``), the switch set on both
sides, f32 conv operands on both. Every consumer of the band convs' bf16
rows runs: the next conv, the height compression, the NRConv stack's
non-conv ops, the BEV's first conv, the pools' ``mlp_in`` and the TED
head's grid features.

Every stream's features and the encoded tensor are bf16 on both sides with
the same coords, and agree within 5e-2 absolute (bf16 rows between the
layers round values next to a rounding boundary apart on the two sides,
whose f32 sums run in other orders, and the differences carry through the
layers); at least 99 % of the values are within one bf16 ulp of JAX's.
The BEV features are f32 on both sides (flax promotes the bf16 rows
against f32 kernels) and within 1e-3 x their scale; the proposals' valid
sets are equal and their boxes within 1e-3; the final ROI valid sets are
equal, the boxes within 5e-2 and the logits within 2e-2 absolute (the
observed differences were 2.4e-6 and 3.7e-8)."""
import numpy as np
import pytest
import torch

from virconv_tpu_torch.models.layers import DenseConvBlock

from test_torch_detector import detector_runs

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VIRCONV_BF16_FEATS', '1')
        return detector_runs()


def pairs(runs):
    _, inter, got = runs
    want, got = inter['backbone']['__call__'][0], got['backbone']
    for stream in ('multi_scale_3d_features', 'multi_scale_3d_features_mm'):
        for k in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
            yield f'{stream} {k}', want[stream][k], got[stream][k]
    yield ('encoded_spconv_tensor', want['encoded_spconv_tensor'],
           got['encoded_spconv_tensor'])


def test_backbone_rows_are_bf16_on_both_sides(runs):
    for name, j, t in pairs(runs):
        assert t.feats.dtype == torch.bfloat16, name
        assert str(j.feats.dtype) == 'bfloat16', name
        np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords),
                                      err_msg=name)


def test_backbone_rows_match_jax(runs):
    for name, j, t in pairs(runs):
        w = np.asarray(j.feats, np.float32)
        g = t.feats.float().numpy()
        np.testing.assert_allclose(g, w, atol=5e-2, rtol=0, err_msg=name)
        near = np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6
        assert near.mean() >= 0.99, (name, near.mean())


def test_bev_and_proposals_match_jax(runs):
    _, inter, got = runs
    want = np.asarray(inter['bev_backbone']['__call__'][0])
    assert got['bev_feats'].dtype == torch.float32
    assert want.dtype == np.float32
    np.testing.assert_allclose(got['bev_feats'].numpy(), want,
                               atol=1e-3 * np.abs(want).max(), rtol=0)
    jrpn = inter['dense_head']['__call__'][0]
    assert np.asarray(jrpn['roi_valid']).any()
    np.testing.assert_array_equal(got['roi_scores'].numpy() > 0,
                                  np.asarray(jrpn['roi_valid']))
    np.testing.assert_allclose(got['rois'].numpy(), np.asarray(jrpn['rois']),
                               atol=1e-3, rtol=0)


def test_final_predictions_match_jax(runs):
    want, _, got = runs
    np.testing.assert_array_equal(got['roi_valid'].numpy(),
                                  np.asarray(want['roi_valid']))
    for k, tol in (('batch_box_preds', 5e-2), ('batch_cls_preds', 2e-2)):
        g = got[k].detach().float().numpy()
        w = np.asarray(want[k], np.float32)
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=k)


def test_bev_conv_promotes_bf16_rows():
    """The BEV's first conv on bf16 rows computes in f32, as flax's
    ``nn.Conv`` does on a bf16 input with f32 kernels: the output of the
    rows' f32 widening, bit for bit."""
    torch.manual_seed(0)
    block = DenseConvBlock(6, 8, stride=(2, 2)).eval()
    x = torch.randn(2, 9, 7, 6).to(torch.bfloat16)
    with torch.no_grad():
        got = block(x)
        want = block(x.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
