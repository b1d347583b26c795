"""The port's AoANet (``models/aoa.py``) against the benchmark's plain
float32 reference (``perfbench/reference/aoa.py``), which imports nothing
of either package, on one draw of ``perfbench.weights.make`` (the
reference reads the tensors, the port loads the same numbers through its
checkpoint path), float32 on the CPU at tiny widths (rnn 32 in 4 heads,
word embedding 16, 12-wide regions, the refiner's 6 layers):

* the refined regions, their mean and ``ctx2att`` within 1e-5, with every
  region valid and with padded regions;
* teacher-forced log-probs within 1e-5;
* beam 3: captions identical, ``lp_sum`` / ``ent_sum`` within 1e-4; a
  beam that skips each row's best token shows in ``caption_sums``;
* the cell's check (``perfbench/checks/beam_captions.py``): the port's
  captions read rounding, the float8 control a gap;
* ``perfbench/flops/aoa.py`` against a hand count at the published
  widths, and B6's launch shape in every body graph."""

import json
import os
import types

import numpy as np
import pytest
import torch

from captioning_tpu_torch.models.api import setup
from perfbench import data, harness, weights
from perfbench.checks import beam_captions
from perfbench.reference import aoa as ref_aoa
from perfbench.reference import common, decode

TINY = dict(vocab_size=30, input_encoding_size=16, rnn_size=32, num_heads=4,
            att_feat_size=12, fc_feat_size=12, max_length=8,
            compute_dtype='float32')
B, M, BEAM = 6, 5, 3
ATOL, SUM_ATOL = 1e-5, 1e-4


def _config():
    with open(os.path.join(harness.HERE, 'configs', 'aoa.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def pair():
    """(port Captioner, float32 reference, its weights, opt)."""
    cfg = _config()
    opt = dict(cfg['options'], **TINY)
    W, host = weights.make(ref_aoa.layout(opt, cfg['init']), 2 ** 31 + 7,
                           'cpu')
    cap = setup(types.SimpleNamespace(**opt),
                data.vocab(opt['vocab_size']), 'cpu').load_jax_variables(host)
    return cap, ref_aoa.Model(common.Weights(W), opt), W, opt


def _inputs(opt, padded):
    fc, att, am = (torch.from_numpy(x) for x in data.features(
        B, M, opt['att_feat_size'], False, 3, 'cpu'))
    if padded:
        am[1::2, 3:] = 0
    return fc, att, am


@pytest.mark.parametrize('padded', [False, True])
def test_prepare_matches(pair, padded):
    cap, ref, _, opt = pair
    fc, att, am = _inputs(opt, padded)
    with torch.no_grad():
        got = cap.module.prepare_feature(fc, att, am)
        mean, x, p_att, _ = ref.prepare(fc, att, am)
    for name, want in (('att_feats', x), ('fc_feats', mean),
                       ('p_att_feats', p_att)):
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('padded', [False, True])
def test_teacher_forced_logprobs_match(pair, padded):
    cap, ref, _, opt = pair
    fc, att, am = _inputs(opt, padded)
    g = torch.Generator().manual_seed(5)
    # two captions an image, the bos first
    seq = torch.randint(1, opt['vocab_size'] + 1, (2 * B, 7), generator=g)
    seq[:, 0] = 0
    rows = torch.arange(B).repeat_interleave(2)
    with torch.no_grad():
        got = cap.module.forward_tf(fc, att, seq, am)
        want = ref.teacher_forced(ref.prepare(fc, att, am), rows, seq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _served(pair, padded=False):
    """The port's beam over the inputs: (seq, stats, reference feats)."""
    cap, ref, _, opt = pair
    fc, att, am = _inputs(opt, padded)
    seq, stats, _ = cap.sample_beam(
        fc, att, am, None, dict(beam_size=BEAM, suppress_UNK=1,
                                max_length=opt['max_length']))
    with torch.no_grad():
        feats = ref.prepare(fc, att, am)
    return seq, stats, feats, (fc, att, am)


@pytest.mark.parametrize('padded', [False, True])
def test_beam_captions_and_sums_match(pair, padded):
    _, ref, _, opt = pair
    seq, stats, feats, _ = _served(pair, padded)
    V, L = opt['vocab_size'], opt['max_length']
    with torch.no_grad():
        best, p = decode.beam_search(ref, feats, B, BEAM, L, V)
        lp, ent, _, below = decode.caption_sums(ref, feats, torch.arange(B),
                                                seq, V, BEAM)
    assert torch.equal(best, seq)
    np.testing.assert_allclose(lp.numpy(), stats['lp_sum'].numpy(),
                               atol=SUM_ATOL, rtol=0)
    np.testing.assert_allclose(ent.numpy(), stats['ent_sum'].numpy(),
                               atol=SUM_ATOL, rtol=0)
    np.testing.assert_allclose(p.numpy(), lp.numpy(), atol=SUM_ATOL, rtol=0)
    assert float(below.max()) == 0.0


def test_a_beam_that_skips_the_best_shows(pair):
    _, ref, _, opt = pair
    _, _, feats, _ = _served(pair)
    V, L = opt['vocab_size'], opt['max_length']
    with torch.no_grad():
        bad, _ = decode.beam_search(ref, feats, B, BEAM, L, V,
                                    skip_best=True)
        below = decode.caption_sums(ref, feats, torch.arange(B), bad, V,
                                    BEAM)[3]
    assert float(below.max()) > 0.0


def test_the_check_reads_rounding_and_the_control_a_gap(pair):
    _, _, W, opt = pair
    seq, stats, _, (fc, att, am) = _served(pair)
    den = (seq > 0).sum(1).double() + 1
    sample = {'images': np.arange(B), 'tokens': seq.numpy(),
              'perplexity': (-stats['lp_sum'].double() / den).numpy(),
              'entropy': (stats['ent_sum'].double() / den).numpy(),
              'fc': fc.numpy(), 'att': att.numpy(), 'am': am.numpy()}
    cell = types.SimpleNamespace(reference=lambda: ref_aoa)
    h = types.SimpleNamespace(options=opt, device='cpu', cell=cell,
                              traffic={'eval_kwargs': {'beam_size': BEAM}})
    served = beam_captions.judge(h, W, sample)
    low = beam_captions.control(h, W, sample)
    for name in ('ppl_gap', 'ent_gap', 'rank_gap'):
        assert served[name] < 1e-4, (name, served)
        assert low[name] > 100 * max(served[name], 1e-5), (name, low)
    assert abs(served['beam_gap_mean']) < 1e-4


# hand counts at the published widths (configs/aoa.json): D = E = 1024,
# F 2048, M 36, V1 9488, 6 refiner layers, multi_head_scale 1
PREPARE = (2 * 36 * 2048 * 1024                        # att_embed
           + 6 * (3 * 2 * 36 * 1024 * 1024             # q, k, v
                  + 2 * 2 * 36 * 36 * 1024             # scores, context
                  + 2 * 36 * 2048 * 2048)              # the AoA gate
           + 2 * 36 * 1024 * 2048)                     # ctx2att
STEP = (2 * 2048 * 4096 + 2 * 1024 * 4096              # attention LSTM
        + 2 * 1024 * 1024 + 2 * 2 * 36 * 1024          # q; scores, context
        + 2 * 2048 * 2048                              # att2ctx
        + 2 * 1024 * 9488)                             # logit


def test_flop_model_at_the_published_widths():
    f = harness.module('flops', 'aoa')
    opt = _config()['options']
    assert f.prepare_flops(opt, 36) == PREPARE == 3504734208
    assert f.step_flops(opt, 36) == STEP == 55230464
    Bn, k = 1000, 5
    assert f.beam_flops(opt, 36, Bn, k, 0) == Bn * (PREPARE + STEP)
    assert f.beam_flops(opt, 36, Bn, k, 1) == 0
    steps = sum(f.beam_flops(opt, 36, Bn, k, g) for g in range(1, 21))
    assert steps == 19 * Bn * k * STEP
    # about 3.5 TFLOP of prepare and 5.3 TFLOP of steps a batch of 1000
    assert f.beam_flops(opt, 36, Bn, k, 0) == pytest.approx(3.56e12, 1e-2)
    assert steps == pytest.approx(5.25e12, 1e-2)


def test_b6_in_every_body_graph():
    f = harness.module('flops', 'aoa')
    opt = _config()['options']
    assert f.beam_launches(opt, 36, 1000, 5, 0) == {}
    for g in range(1, 21):
        assert f.beam_launches(opt, 36, 1000, 5, g) == {
            'topk_lastdim': dict(B=1000, C=5 * 9488, k=5)}
