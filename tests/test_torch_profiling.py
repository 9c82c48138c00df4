"""mmd_tpu_torch/profiling.py's reduction of a torch.profiler window, on
made-up events (the profilers themselves need a card)."""

from collections import namedtuple

from torch.autograd import DeviceType

from mmd_tpu_torch.profiling import device_summary

Evt = namedtuple("Evt", "key device_type device_time_total count")


def test_device_summary_names_groups_and_idle_share():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Evt("void flash_fwd_kernel<32, float>", cuda, 3000.0, 2),
              Evt("ampere_sgemm_128x64_nn", cuda, 1000.0, 4),
              Evt("aten::mm", cpu, 5000.0, 4),
              Evt("Memcpy HtoD (Pageable -> Device)", cuda, 500.0, 1),
              Evt("some_kernel", cuda, 500.0, 1)]
    kernels = {"flash_fwd_kernel": "flash_attn_fwd",
               "dropout_kernel": "dropout"}
    s = device_summary(events, 10.0, kernels,
                       (("some", "mine"),), top=2)
    assert s["device_busy_ms"] == 5.0          # the host operator left out
    assert s["idle_share"] == 0.5
    assert s["device_events"] == 8
    assert s["device_ms_by_group"] == {"flash_attn_fwd": 3.0, "other": 1.5,
                                       "mine": 0.5}
    assert list(s["device_ms_top"]) == ["flash_attn_fwd",
                                        "ampere_sgemm_128x64_nn"]
    assert s["kernels_ms"] == {"flash_attn_fwd": 3.0, "dropout": 0.0}
    s = device_summary(events, 10.0, kernels)
    assert s["device_ms_by_group"] == {"flash_attn_fwd": 3.0, "matmul": 1.0,
                                       "copies": 0.5, "other": 0.5}
