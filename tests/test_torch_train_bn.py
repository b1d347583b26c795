"""The port's XE train step against the JAX ``Trainer.xe_step`` (as in
``test_torch_train_step.py``) with use_bn 1 and 2, where the BatchNorms'
running statistics, folded in place by the port and carried in
``batch_stats`` by JAX, also agree within 1e-5 after the 3 steps, and
with drop_worst (the 'none'-reduced criterion and the mean of its
smallest k): alone on NewFC, with use_bn 2 on the transformer and
UpDown."""

import jax
import numpy as np
import pytest
import torch

from captioning_tpu.utils.misc import _flatten_tree
from tests.torch_train_util import check_losses, model_opt, run_both


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one encoder and one decoder layer: the variants exercise the BatchNorms
# and the criterion, not the layer stack (test_torch_train_step.py has two)
ONE_LAYER = dict(N_enc=1, N_dec=1)


@pytest.mark.parametrize('use_bn', [1, 2])
@pytest.mark.parametrize('model', ['transformer', 'updown'])
def test_xe_step_with_use_bn_matches_jax(model, use_bn):
    """use_bn 2 also takes drop_worst (the two touch different ends of the
    step: the features' statistics, the loss's reduction)."""
    kw = ONE_LAYER if model == 'transformer' else {}
    drop_worst = use_bn == 2
    want, got, variables, _, pcap, _ = run_both(
        model_opt(model, use_bn=use_bn, drop_worst_rate=0.3, **kw),
        drop_worst=drop_worst)
    check_losses(want, got)
    want_stats = _flatten_tree({'batch_stats': jax.tree.map(
        np.asarray, variables['batch_stats'])})
    got_stats = {k: v for k, v in _flatten_tree(pcap.jax_variables()).items()
                 if k.startswith('batch_stats/')}
    assert sorted(got_stats) == sorted(want_stats) and len(want_stats) == \
        2 * use_bn
    for key, w in want_stats.items():
        assert not np.allclose(w, w.flat[0])       # the stats did move
        np.testing.assert_allclose(got_stats[key], w, atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize('model', ['newfc'])
def test_xe_step_with_drop_worst_matches_jax(model):
    want, got, _, _, _, _ = run_both(model_opt(model, drop_worst_rate=0.3),
                                     drop_worst=True)
    check_losses(want, got)
