"""The port's XE train step (``modules/trainer.py``: the teacher-forced
pass in train mode, the criterion, backward, clip and the optimizer step)
against the JAX ``Trainer.xe_step`` from the same weights (the JAX init
loaded into the port), on the same batch, float32 on the CPU, dropout 0
and ``ss_prob`` 0 (the two frameworks' random streams never agree; the
random parts are held by their own properties in
``test_torch_train_random.py``): 3 steps of adam with clip by value, per
model key (the transformer and the ten RNN keys, split with
``test_torch_train_step_zoo.py`` to keep each file short).  The first loss
within 1e-5 relative, the 3-step trajectory within 1e-4, and the
optimizer state, in the JAX package's layout, within 1e-6."""

import pytest
import torch

from tests.torch_train_util import (check_losses, check_opt_state,
                                    model_opt, run_both)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('model', ['transformer', 'updown', 'att2in2',
                                   'att2all2', 'stackatt'])
def test_xe_step_matches_jax(model):
    want, got, _, state, _, pt = run_both(model_opt(model))
    check_losses(want, got)
    check_opt_state(state, pt)
