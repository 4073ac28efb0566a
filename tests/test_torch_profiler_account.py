"""The profiler's launch account on a synthetic chrome trace: per kernel
of the port, the launches its counter saw in the window, the device
records the trace holds and the unrecorded difference; the summary's
table warns when a launch lost its record."""
import warnings

import pytest

from paddle_tpu_torch import profiler as P


def _trace():
    """Host launches 1-6 in time order; the device dropped the records of
    correlations 2 (a flash_fwd launch) and 5 (one of torch's)."""
    ev = []
    names = {1: "void flash_fwd_mma<64>(Params)", 2: None,
             3: "ffn_tiled_up_kernel<128>", 4: "ffn_tiled_down_kernel<128>",
             5: None, 6: "paged_decode_kernelIf13__nv_bfloat16Li8E"}
    for c, name in names.items():
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": 10.0 * c, "args": {"correlation": c}})
        if name is not None:
            ev.append({"cat": "kernel", "name": name, "ts": 10.0 * c + 3,
                       "dur": 2.0, "args": {"correlation": c}})
    ev.append({"cat": "kernel", "name": "void at::native::vectorized_kernel",
               "ts": 1.0, "dur": 1.0, "args": {"correlation": 99}})
    return {"traceEvents": ev}


def test_account_names_the_unrecorded_launches_per_kernel():
    counted = {"flash_fwd": 2, "ffn_tiled": 1, "paged_decode": 1}
    acc = P.launch_account(_trace(), counted)
    assert acc["kernels"] == {
        "ffn_tiled": {"counted": 1, "recorded": 1, "unrecorded": 0},
        "flash_fwd": {"counted": 2, "recorded": 1, "unrecorded": 1},
        "paged_decode": {"counted": 1, "recorded": 1, "unrecorded": 0}}
    assert acc["launches_without_record"] == 2
    assert acc["unattributed"] == 1
    for k in acc["kernels"].values():
        assert k["recorded"] + k["unrecorded"] == k["counted"]


def test_summary_table_warns_when_a_record_is_lost():
    acc = P.launch_account(_trace(), {"flash_fwd": 2, "ffn_tiled": 1,
                                      "paged_decode": 1})
    with pytest.warns(RuntimeWarning, match="no device record"):
        lines = P._account_lines(acc)
    text = "\n".join(lines)
    assert "flash_fwd" in text and "launches without a device record: 2" \
        in text
    whole = P.launch_account(_trace(), {})
    whole["launches_without_record"] = 0
    whole["kernels"] = {n: {**k, "unrecorded": 0}
                        for n, k in whole["kernels"].items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        P._account_lines(whole)
