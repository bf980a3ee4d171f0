"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W power limit): fp32 outside the tensor cores, with a fused multiply-add
counted as 2 operations; INT32 from the SM's 64 INT32 lanes at 1.98 GHz on
132 SMs, in instructions per second; HBM3 bandwidth.  Fixed here, so no
program's own probe can move a share's denominator.  A run prints the
card's power limit beside every share."""

FP32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9
HBM_BYTES = 3.35e12


def ops_time_ms(fp_ops: float, int_ops: float = 0.0) -> float:
    """The least time of these operations: fp32 over the fp32 peak, INT32
    over the INT32 rate, where both share the warp schedulers' one dispatch
    per clock and INT32 has half the lanes: max(t_fp + t_int / 2, t_int)."""
    t_fp = fp_ops / FP32_FLOPS * 1e3
    t_int = int_ops / INT32_OPS * 1e3
    return max(t_fp + t_int / 2.0, t_int)


def bound_ms(fp_ops: float, int_ops: float, nbytes: float) -> float:
    """The least time of a launch: the larger of its operations' time and
    its bytes over the HBM rate."""
    return max(ops_time_ms(fp_ops, int_ops), nbytes / HBM_BYTES * 1e3)
