"""BAD: host reads inside capture regions (the test declares
``decode_step`` and the loop body of ``Engine.decode_loop`` as capture
roots).  13 findings, one per marked line."""
import numpy as np
import torch


def decode_step(x: torch.Tensor, cache):
    stop = x.sum().item()                     # BCG-HOST-SYNC .item()
    rows = x.tolist()                         # BCG-HOST-SYNC .tolist()
    host = x.cpu()                            # BCG-HOST-SYNC .cpu()
    arr = host.numpy()                        # BCG-HOST-SYNC .numpy()
    torch.cuda.synchronize()                  # BCG-HOST-SYNC synchronize
    if bool(x.any()):                         # BCG-HOST-SYNC bool() of a tensor
        x = x + 1
    n = int(x.sum())                          # BCG-HOST-SYNC int() of a tensor
    if x.max() > 0:                           # BCG-HOST-SYNC tensor as an if test
        x = x * 2
    idx = torch.nonzero(x)                    # BCG-HOST-SYNC torch.nonzero
    live = x[x > 0]                           # BCG-HOST-SYNC boolean-mask indexing
    flat = np.asarray(cache)                  # BCG-HOST-SYNC np.asarray
    return x * stop + n + len(rows) + arr.size + idx.numel() + live.numel() + flat.size


class Engine:
    def decode_loop(self, x: torch.Tensor, steps: int):
        first = x.max().item()                # set-up before the loop: quiet
        done = x < 0
        for i in range(steps):
            while (done == 0).all():          # BCG-HOST-SYNC tensor as a while test
                done = done | (x > i)
            x = decode_step(x, None)
            if x.sum().item() > first:        # BCG-HOST-SYNC .item()
                break
        return x
