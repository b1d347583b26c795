"""A hand-written kernel's least time at a shape: one file a kernel
wrapper (``captioning_tpu_torch/ops``), named by the wrapper, with
``SYMBOLS`` (the CUDA functions its launches run, as the profiler names
them) and ``bound_s(shape)``: the larger of the bytes it must move over
the card's memory rate and its operations over the peak for their type
(``peaks.py``).  The counts are frozen copies of ``chip_smoke.py``'s
(its ``kernels`` line), each input byte read once and each output byte
written once."""
