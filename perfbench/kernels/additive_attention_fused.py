"""B3, ``ops/attention.py:additive_attention_fused``
(``csrc/additive_attention.cu``): UpDown's attention head after h2att,
tanh of the query plus the region keys, alpha_net, softmax, mask and the
weighted sum, ``bw`` query rows sharing an image's regions.

Bytes (``chip_smoke.py:time_additive_attention``): att_h [nb bw, A], the
regions [nb, M, H] and keys [nb, M, A], alpha_net, the output [nb bw, H]
in the compute dtype, the float32 mask [nb, M].  Operations: nb bw M
(3 A + 2 H) float32."""

from perfbench import peaks

SYMBOLS = ('additive_attention_kernel', 'additive_attention_ring')


def bound_s(s):
    nb, bw, M, H, A, e = (s['nb'], s['bw'], s['M'], s['H'], s['A'],
                          s['dtype_bytes'])
    nbytes = (e * (nb * bw * A + nb * M * H + nb * M * A + A + 1
                   + nb * bw * H) + 4 * nb * M)
    return peaks.bound_s(nbytes, float(nb * bw * M * (3 * A + 2 * H)),
                         peaks.F32)
