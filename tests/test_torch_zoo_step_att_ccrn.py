"""Zoo training, att_ccrn: three make_stateful_train_step steps against
JAX's (tests/torch_zoo_common.py; split out of
tests/test_torch_zoo_train.py so that --dist loadfile spreads it)."""

import pytest

from torch_zoo_common import three_stateful_steps


@pytest.mark.parametrize("family", ["att_ccrn"])
def test_three_stateful_steps_match_jax(rng, family):
    """Three make_stateful_train_step steps (make_optimizer's Adam at lr
    1e-3) vs JAX's on one batch of 2, the pre-BatchNorm biases' gradients
    stopped in both (_comparable): the loss at every step within
    LOSS_RTOL, the BatchNorm statistics as _assert_state_close says after
    every step; then the parameters as _assert_params_close
    says and the optimizer state: optax's tree, leaf for leaf, the moments
    within OPT_REL."""
    three_stateful_steps(rng, family)
