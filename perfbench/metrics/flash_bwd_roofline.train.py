"""Row 6's share of its roofline: the least time of every `flash_bwd` call in the traced window (five products from the saved row statistics, `perfbench/flops`) over the device time of the operations those calls launched (on the autograd thread)."""

from perfbench import flops


def read(run):
    if not run or not run["bwd"]:
        return None
    device_s = run["trace"].span_device.get("flash_bwd", {}).get("all")
    if not device_s:
        return None
    least = 0.0
    for args in run["bwd"]:
        (b, h, s_q, d), dtype, elem = args[0]
        s_k = args[1][0][2]
        bias_shape, _, bias_elem = args[3]
        n = 1
        for x in bias_shape:
            n *= x
        t = flops.attention_bwd_roofline_s(b, h, s_q, s_k, d, elem, n, bias_elem, run["device_kind"],
                      "bf16" if dtype in ("bfloat16", "float16") else "fp32")
        if t is None:
            return None
        least += t
    return 100.0 * least / device_s
