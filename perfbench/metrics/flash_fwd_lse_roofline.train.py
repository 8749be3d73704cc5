"""Row 5's share of its roofline: the least time of every `flash_fwd_lse` call in the traced window (`perfbench/flops`) over the device time of the operations those calls launched."""

from perfbench import flops


def read(run):
    if not run or not run["fwd_lse"]:
        return None
    device_s = run["trace"].span_device.get("flash_fwd_lse", {}).get("all")
    if not device_s:
        return None
    least = 0.0
    for args in run["fwd_lse"]:
        (b, h, s_q, d), dtype, elem = args[0]
        s_k = args[1][0][2]
        bias_shape, _, bias_elem = args[3]
        n = 1
        for x in bias_shape:
            n *= x
        t = flops.attention_roofline_s(b, h, s_q, s_k, d, elem, n, bias_elem, run["device_kind"],
                      "bf16" if dtype in ("bfloat16", "float16") else "fp32")
        if t is None:
            return None
        least += t
    return 100.0 * least / device_s
