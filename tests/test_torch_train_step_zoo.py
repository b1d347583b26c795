"""The port's XE train step against the JAX ``Trainer.xe_step`` (as in
``test_torch_train_step.py``) for the other nine RNN keys (show_tell
with its LSTM and its GRU), and with
seq_per_img 1 and use_pallas (StackAtt with label smoothing), where B3
takes aligned
rows, so both sides differentiate their kernel's wrapper (the JAX custom
VJP in interpret mode, the port's autograd Function over the twin)."""

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


@pytest.mark.parametrize('model', ['denseatt', 'adaatt', 'adaattmo', 'newfc',
                                   'fc', 'language_model', 'att2in',
                                   'show_tell', 'show_tell_gru'])
def test_xe_step_matches_jax(model):
    want, got, _, state, _, pt = run_both(model_opt(model))
    check_losses(want, got)
    check_opt_state(state, pt)


@pytest.mark.parametrize('model,label_smoothing', [('updown', 0.0),
                                                   ('stackatt', 0.2)])
def test_xe_step_through_the_attention_wrapper_matches_jax(model,
                                                           label_smoothing):
    """StackAtt also takes label smoothing (the criterion's other form)."""
    want, got, _, state, _, pt = run_both(model_opt(
        model, use_pallas=1, seq_per_img=1,
        label_smoothing=label_smoothing), spi=1)
    check_losses(want, got)
    check_opt_state(state, pt)
