"""torch-hygiene fixture (firing): one finding per sub-check.

Line numbers matter — tests assert findings land on the marked lines.
"""
import torch


def entry(x, ids, n):
    a = x.sum().item()                      # host-sync .item() (line 9)
    b = ids.tolist()                        # host-sync .tolist() (line 10)
    c = x.cpu()                             # host-sync .cpu() (line 11)
    d = x.detach().numpy()                  # host-sync .numpy() (line 12)
    e = x.to("cpu")                         # host-sync .to("cpu") (line 13)
    f = float(x.max())                      # host-sync float() (line 14)
    if x.sum() > 0:                         # branch-on-tensor if (line 15)
        pass
    while ids.any():                        # branch-on-tensor while (line 17)
        break
    assert x.isfinite().all()               # branch-on-tensor assert (line 19)
    g = 1 if x.mean() else 0                # conditional expression (line 20)
    h = [r for r in x if r.sum()]           # comprehension if (line 21)
    keep = x > 0
    i = x[keep]                             # boolean-mask load (line 23)
    x[x < 0] = 0.0                          # boolean-mask store (line 24)
    j = ids.nonzero()                       # .nonzero() (line 25)
    k = torch.unique(ids)                   # torch.unique (line 26)
    m = x.repeat_interleave(ids, dim=0)     # repeat_interleave (line 27)
    o = torch.where(keep)                   # one-argument where (line 28)
    p = torch.tensor([1, 2], device=x.device)  # host-to-device (line 29)
    q = total(x)                            # int() in the callee (line 35)
    return a, b, c, d, e, f, g, h, i, j, k, m, o, p, q, helper(n)


def total(t):
    return int(t.sum())


def helper(n, opts={}):                     # unhashable-default (line 38)
    return n
