"""GOOD: host reads only outside capture regions, or inside the runtime
audit's seams (``with obs_hostsync.expected():``); shape metadata and
identity tests are host values, not reads of the device."""
import numpy as np
import torch

from bcg_tpu_torch.obs import hostsync as obs_hostsync


def decode_step(x: torch.Tensor, cache, bias=None):
    if bias is not None:                      # identity: no device read
        x = x + bias
    if x.shape[0] > 4:                        # shape metadata
        x = x[:4]
    n = int(x.shape[-1])                      # shape metadata
    keep = torch.where(x > 0, x, torch.zeros_like(x))  # device select
    return keep * n


class Engine:
    def _all_done(self, done):
        obs_hostsync.note("done_poll", entry="decode_loop")
        with obs_hostsync.expected():
            return bool(done.all())

    def decode_loop(self, x: torch.Tensor, steps: int):
        done = x < 0
        for i in range(steps):
            if i % 8 == 0:
                obs_hostsync.note("done_poll", entry="decode_loop")
                with obs_hostsync.expected():
                    if bool(done.all()):      # a counted seam: exempt
                        break
            x = decode_step(x, None)
            done = done | (x > i)
        with obs_hostsync.expected():
            return x.cpu().numpy()


def orchestrate(x):
    out = Engine().decode_loop(torch.as_tensor(x), 4)
    torch.cuda.synchronize()                  # host side: fine
    return np.asarray(out).item()             # host side: fine
