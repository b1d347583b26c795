"""Shared check of the port's graph programs on the CPU: ``NoHostRead``, a
dispatch mode that fails on any op that reads a tensor's value on the host
(the reads a CUDA graph cannot hold)."""

from torch.utils._python_dispatch import TorchDispatchMode

HOST_READS = ('aten._local_scalar_dense', 'aten.item', 'aten.is_nonzero',
              'aten.nonzero')


class NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor's value on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_READS):
            raise AssertionError('host read in the step body: %s' % func)
        return func(*args, **(kwargs or {}))
