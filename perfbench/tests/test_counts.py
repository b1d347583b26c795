"""The FLOP models and the kernels' byte and operation counts, against
hand counts at the cells' shapes."""

import json
import os

import pytest

from perfbench import harness, peaks


def _opt(name):
    with open(os.path.join(harness.HERE, 'configs', name + '.json')) as f:
        return json.load(f)['options']


TF, UD = _opt('transformer'), _opt('updown')


def test_transformer_decode_step():
    # per layer 16 d^2 + 4 T d + 4 M d + 4 d f at d 512, f 2048, T 21,
    # M 36: 4194304 + 43008 + 73728 + 4194304; six layers; the logits
    # 2 d V1 = 2 x 512 x 9488
    f = harness.module('flops', 'transformer')
    assert f.decode_step_flops(TF, 36, 21) == 6 * 8505344 + 9715712
    assert f.decode_step_flops(TF, 36, 21) == pytest.approx(60.7e6, 1e-3)


def test_transformer_encoder():
    # att embed 2 x 36 x 2048 x 512; a layer 8 M d^2 + 4 M^2 d + 4 M d f
    f = harness.module('flops', 'transformer')
    layer = 75497472 + 2654208 + 150994944
    assert f.encoder_flops(TF, 36) == 75497472 + 6 * layer


def test_transformer_beam_graphs():
    f = harness.module('flops', 'transformer')
    B, k = 1000, 5
    assert f.beam_flops(TF, 36, B, k, 0) == B * (
        f.encoder_flops(TF, 36) + f.decode_step_flops(TF, 36, 1))
    assert f.beam_flops(TF, 36, B, k, 1) == 0
    assert f.beam_flops(TF, 36, B, k, 11) == B * k * f.decode_step_flops(
        TF, 36, 11)
    assert f.beam_launches(TF, 36, B, k, 1) == {}
    b1 = f.beam_launches(TF, 36, B, k, 11)['attend_write_merged']
    assert (b1['N'], b1['t0'], b1['bw']) == (5000, 10, 5)
    assert f.beam_launches(TF, 36, B, k, 0)['logit_topk']['N'] == 1000


def test_updown_step():
    # att LSTM 2 (2H + E) 4H + 2 H 4H; attention 2 H A + 2 M A + 2 M H;
    # language LSTM 2 (2H) 4H + 2 H 4H; logit 2 H V1
    f = harness.module('flops', 'updown')
    assert f.step_flops(UD, 36) == (24000000 + 8000000
                                    + 1024000 + 36864 + 72000
                                    + 16000000 + 8000000 + 18976000)
    assert f.prepare_flops(UD, 36) == (2 * 2048 * 1000 + 2 * 36 * 2048
                                       * 1000 + 2 * 36 * 1000 * 512)
    assert f.beam_launches(UD, 36, 1000, 5, 0) == {
        'additive_attention_fused': dict(nb=1000, M=36, H=1000, A=512,
                                         dtype_bytes=2, bw=1)}
    assert set(f.beam_launches(UD, 36, 1000, 5, 1)) == {'topk_lastdim'}


def _bound(name, **shape):
    return harness.module('kernels', name).bound_s(shape)


def test_b2_bound():
    # 2 N D V1 bf16 products at 989e12 beat the bytes
    # 2 (N D + V1 D + V1) + 40 N + 8 N
    s = _bound('logit_topk', N=5000, D=512, V1=9488, k=5, dtype_bytes=2)
    assert s == pytest.approx(48578560000 / 989e12)
    assert 15094688 / 3.35e12 < s


def test_b1_bound():
    # bytes 2 (3 N D + 2 (N / bw) t0 D + 3 N D) + 4 N t0 at N 5000, t0 10
    s = _bound('attend_write_merged', N=5000, D=512, h=8, bw=5, t0=10,
               dtype_bytes=2)
    assert s == pytest.approx(51400000 / 3.35e12)


def test_b3_bound():
    s = _bound('additive_attention_fused', nb=1000, bw=5, M=36, H=1000,
               A=512, dtype_bytes=2)
    assert s == pytest.approx(124129026 / 3.35e12)
    # chip_smoke.py's own bound at 1024 images: 0.0379 ms
    s1024 = _bound('additive_attention_fused', nb=1024, bw=5, M=36,
                   H=1000, A=512, dtype_bytes=2)
    assert s1024 * 1e3 == pytest.approx(0.0379, abs=5e-5)


def test_b6_bound():
    s = _bound('topk_lastdim', B=1000, C=47440, k=5)
    assert s == pytest.approx(189820000 / 3.35e12)


def test_peaks():
    assert peaks.bf16_flops('NVIDIA H100 80GB HBM3') == 989.4e12
    with pytest.raises(KeyError):
        peaks.bf16_flops('some other card')
