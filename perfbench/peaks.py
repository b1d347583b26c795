"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
full 700 W power limit), by ``torch.cuda.get_device_name``.  The bf16
peak is a frozen copy of ``captioning_tpu_torch/tools/bench.py:
PEAK_BF16_TFLOPS``; the memory rate and the float32 peak of
``chip_smoke.py``'s bounds."""

BF16_TFLOPS = {'NVIDIA H100 80GB HBM3': 989.4}
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR = 989e12       # bf16 products on the tensor cores
F32 = 67e12                # float32 outside the tensor cores


def bf16_flops(name: str) -> float:
    """The card's dense bf16 peak in FLOP/s; an unknown card raises."""
    if name not in BF16_TFLOPS:
        raise KeyError('no published bf16 peak for %r (known: %s)'
                       % (name, sorted(BF16_TFLOPS)))
    return BF16_TFLOPS[name] * 1e12


def bound_s(nbytes, flops, peak):
    """The least time: the larger of bytes over the memory rate and
    operations over ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
