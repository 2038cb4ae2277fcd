"""torch-hygiene fixture (clean): branches on metadata, Python values and
a ctypes-style return code; tensors stay on the device throughout."""
import torch

BLOCKS = (128, 64)


def entry(x, ids, block_t, opts=None):
    t, k = x.shape
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_cuda:
        raise ValueError("x")
    if block_t not in BLOCKS or t % block_t or x.numel() == 0:
        raise ValueError("block_t")
    if opts is None and x.is_contiguous() and x.stride(1) == 1:
        pass
    if ids is not None and ids.data_ptr() % 16 == 0:
        pass
    n = rows(x)
    scale = float(k) ** -0.5 if k else 1.0
    err = launch(x.data_ptr(), ids.data_ptr(), t, k)
    if err:
        raise RuntimeError(err)
    kinds = {v.device.type for v in (x, ids)}
    mask = ids >= 0
    y = torch.where(mask[:, None], x * scale, 0.0)
    cols = torch.arange(n, device=x.device)
    z = (lambda a: a * 2)(y)
    return y.to(x.dtype), cols, z, kinds, helper(n, block_t)


def rows(x):
    return x.shape[0]


def helper(n, block_t):
    if n > block_t:              # Python ints: no tensor here
        return int(n // block_t)
    return [i for i in range(n) if i % 2]


def launch(*ptrs):
    return 0
