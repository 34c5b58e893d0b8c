"""The checks of tests/test_torch_multi_step.py (three training steps of
the port against three of the JAX package, from the same weights and the
same draws, with its tolerances) on the tiny-L preset of
tests/test_torch_virconv_l_step.py: its config with dropout off, the
sparse-grid batch as one fused stream."""
import pytest

from test_torch_multi_step import (  # noqa: F401  (the checks, run on L)
    run_both, test_bn_statistics_each_step, test_gradients_each_step,
    test_loss_terms_each_step, test_optimizer_state_each_step,
    test_parameters_each_step)
from test_torch_virconv_l import train_setup


@pytest.fixture(scope='module')
def runs():
    return run_both(train_setup)
