"""``Captioner.scan_logprobs`` (``engine/decoding.scan_logprobs``, the
recompute over a sampled sequence that SCST differentiates) against the
JAX package's ``scan_logprobs`` on the same weights, inputs and sequences
(float32, CPU), for the transformer (its train-mode step: the plain
per-row route), UpDown and NewFC: the values in eval mode within 1e-5,
equal to the port's own sampled tables; and, at dropout 0, the gradient of
the summed chosen-token logprobs against ``jax.grad`` of the JAX recompute
in train mode, each parameter within 1e-5 of its tensor's largest
magnitude (1e-5 absolute below magnitude 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captioning_tpu.engine import decoding as jdec
from captioning_tpu.utils.misc import _flatten_tree
from captioning_tpu_torch.utils.weights import jax_from_state_dict
from tests.torch_port_util import (inputs, jax_and_port, jax_draws,
                                   tiny_rnn_opt)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=['transformer', 'updown', 'newfc'])
def models(request):
    opt = None if request.param == 'transformer' else tiny_rnn_opt(
        request.param)
    # a raised EOS bias: some captions end early, their tail steps zeroed
    return jax_and_port(seed=4, opt=opt, eos_boost=2.0)


def _sampled(pcap, fc, att, am):
    """Two sampled captions an image, and the tables they came with."""
    opt = {'sample_method': 'sample', 'sample_n': 2, 'temperature': 1.0,
           'beam_size': 1}
    return pcap.sample(*[torch.from_numpy(a) for a in (fc, att, am)],
                       jax_draws(2, pcap.cfg.seq_length), opt)


def test_scan_logprobs_matches_jax(models):
    jcap, variables, pcap = models
    fc, att, am = inputs(B=3, seed=2)
    seq, tables = _sampled(pcap, fc, att, am)
    want = jax.jit(lambda f, a, m, s: jdec.scan_logprobs(
        jcap.bind(variables), f, a, m, s, jax.random.PRNGKey(0),
        sample_n=2))(*[jnp.asarray(x) for x in (fc, att, am)],
                     jnp.asarray(seq.numpy().astype('int32')))
    got = pcap.scan_logprobs(*[torch.from_numpy(a) for a in (fc, att, am)],
                             seq, sample_n=2)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the recompute of an unconstrained sample is its stored tables
    np.testing.assert_allclose(got.numpy(), tables.numpy(), atol=1e-5,
                               rtol=0)
    assert (got.numpy() == 0).all(-1).any()      # steps past a finish


@pytest.mark.parametrize('model', ['transformer', 'updown'])
def test_scan_logprobs_grad_matches_jax(model):
    opt = None if model == 'transformer' else tiny_rnn_opt(model)
    jcap, variables, pcap = jax_and_port(seed=5, opt=opt)
    fc, att, am = inputs(B=2, seed=3)
    seq, _ = _sampled(pcap, fc, att, am)
    sq = jnp.asarray(seq.numpy().astype('int32'))

    def loss(params):
        dm = jcap.bind(dict(variables, params=params), train=True)
        lp = jdec.scan_logprobs(dm, *[jnp.asarray(x) for x in (fc, att, am)],
                                sq, jax.random.PRNGKey(0), sample_n=2)
        return jnp.take_along_axis(lp, sq[..., None], axis=2).sum()
    want = _flatten_tree({'params': jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(variables['params']))})

    pcap.trainable()
    lp = pcap.scan_logprobs(*[torch.from_numpy(a) for a in (fc, att, am)],
                            seq, torch.Generator().manual_seed(0), sample_n=2)
    assert lp.requires_grad
    lp.gather(2, seq.clone()[..., None]).sum().backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in pcap.module.named_parameters()}
    got = jax_from_state_dict(grads, pcap.cfg, params_only=True)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[key], w, atol=1e-5 * scale, rtol=0,
                                   err_msg=key)
