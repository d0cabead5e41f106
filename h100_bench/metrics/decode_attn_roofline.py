"""B3a, the bf16 decode-attention kernel, against its bandwidth bound:
the K and V bytes the window's decode steps need (each served token
after the first attends its own context, every layer and kv head, bf16)
at the card's published 3.35 TB/s, over the device time of the kernels
named below in the traced window."""

from h100_bench import counts

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels: decode attention (ops/decode_attention.py, csrc/decode_attention.cu)"
MOVES = "decisions_per_s"
KERNELS = ("decode_attention_kernel",)
KV_BYTES = {"bfloat16": 2}


def read(run):
    peaks = counts.peaks_for(run.device_name)
    if run.trace is None or peaks is None:
        return None
    kv = KV_BYTES.get(run.settings.get("kv_cache_dtype", "bfloat16"))
    seconds, launches = run.trace.kernel_seconds(KERNELS)
    if kv is None or not launches:
        return None
    need = sum(counts.decode_kv_bytes(run.model, len(j.prompt), len(j.served), kv)
               for j in run.rows if j.served)
    return 100.0 * need / peaks["hbm_bytes_per_s"] / seconds
