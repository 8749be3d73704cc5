"""Row 1's share of its roofline: the least time of every call of
`flash_sdpa_folded_v3` in the traced window (the larger of its operations
over the tensor-core peak of its dtype and its bytes over the card's
bandwidth, `perfbench/flops`) over the device time of the operations
those calls launched."""

from perfbench import flops


def read(run):
    if not run or not run["row1"]:
        return None
    device_s = run["trace"].span_device.get("flash_sdpa_folded_v3", {}).get("all")
    if not device_s:
        return None
    least = 0.0
    for q, k, _v, bias, h in run["row1"]:
        (b, s_q, hd), dtype, elem = q
        s_k = k[0][1]
        t = flops.attention_roofline_s(b, h, s_q, s_k, hd // h, elem,
                                       _numel(bias[0]), bias[2], run["device_kind"],
                                       "bf16" if dtype in ("bfloat16", "float16") else "fp32")
        if t is None:
            return None
        least += t
    return 100.0 * least / device_s


def _numel(shape):
    n = 1
    for x in shape:
        n *= x
    return n
