"""`Elsewhere`: a tensor that says it lies on an XPU, a device the port
has no kernel for (this CPU build of torch cannot allocate one), for the
tests that a kernel wrapper refuses any device but CUDA, the CPU and
meta. Any op on it raises."""
import torch


class Elsewhere(torch.Tensor):
    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)


def elsewhere(t: torch.Tensor) -> "Elsewhere":
    """An `Elsewhere` of ``t``'s shape and dtype."""
    return Elsewhere(*t.shape, dtype=t.dtype)
