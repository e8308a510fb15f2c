"""``chip_smoke.trace_check``, the completeness check of a torch.profiler
trace, on synthetic event lists of (name, on_device, correlation id)
tuples: a whole trace, an empty one, one that lost device records, and a
``match`` that names a kernel whose launches ``cuda_kernels`` counts. Exact
counts; no card."""

import pytest

import chip_smoke as S

PROBE = ("void (anonymous namespace)::hash_join_probe_kernel<4, 1>(long "
         "long const*, int const*, long long const*, long, int, int*, bool*)")
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4>"


def _trace(launches: int, probes: int, copies: int, lost=()):
    """A trace of ``launches`` kernel launches (the first ``probes`` of them
    the probe kernel, the rest an elementwise one) and ``copies`` async
    copies, as the host enqueued them (correlation ids 1, 2, ...) and as the
    device ran them, less the device records of the correlation ids in
    ``lost``; with host calls that enqueue nothing."""
    calls = ["cudaLaunchKernel"] * launches + ["cudaMemcpyAsync"] * copies
    records = ([PROBE] * probes + [ELEMENTWISE] * (launches - probes)
               + ["Memcpy HtoD (Pinned -> Device)"] * copies)
    host = [(c, False, i + 1) for i, c in enumerate(calls)] + [
        ("aten::empty", False, 0), ("cudaStreamSynchronize", False, 0),
        ("cudaDeviceSynchronize", False, 0)]
    device = [(r, True, i + 1) for i, r in enumerate(records)
              if i + 1 not in lost]
    return host + device


def test_whole_trace():
    assert S.trace_check(_trace(10, 4, 3)) == (13, 13, 13, "")
    assert S.trace_check(_trace(10, 4, 3), "hash_join_probe_kernel",
                         4) == (13, 13, 4, "")


@pytest.mark.parametrize("events", [[], [("cudaLaunchKernel", False, 1)] * 5,
                                    [("aten::add", False, 0)]],
                         ids=["nothing", "host_only", "no_enqueue"])
def test_empty_trace_is_short(events):
    assert S.trace_check(events)[3] == "no device records"


@pytest.mark.parametrize("lost", [(1,), (1, 2, 3), (5, 13), tuple(range(2,
                                                                        13))])
def test_trace_that_lost_device_records_is_short(lost):
    device, host, _m, why = S.trace_check(_trace(10, 4, 3, lost))
    assert (device, host) == (13 - len(lost), 13)
    assert why == (f"{len(lost)} of 13 host enqueue calls without a device "
                   f"record ({13 - len(lost)} device records)")


def test_lost_record_hidden_by_an_extra_one_is_short():
    # as many device records as host calls, but one call's record is lost
    # and a record no traced call enqueued stands in its place
    events = _trace(10, 4, 3, lost=(7,)) + [(ELEMENTWISE, True, 99)]
    assert S.trace_check(events)[:2] == (13, 13)
    assert S.trace_check(events)[3].startswith("1 of 13 host enqueue calls")


@pytest.mark.parametrize("call", ["cudaLaunchKernel", "cudaLaunchKernelExC",
                                  "cuLaunchKernel", "cuLaunchKernelEx",
                                  "cudaMemcpyAsync", "cudaMemsetAsync"])
def test_each_enqueue_call_expects_a_device_record(call):
    events = [(call, False, 1), (call, False, 2), ("Memset (Device)", True, 1)]
    assert S.trace_check(events) == (
        1, 2, 1, "1 of 2 host enqueue calls without a device record (1 "
        "device records)")
    assert S.trace_check(events + [("Memset (Device)", True, 2)])[3] == ""


def test_match_naming_a_counted_kernel_holds_its_launches():
    # a counted kernel: the records device_ms wants are its launches
    counter, per = S.COUNTED["hash_join_probe_kernel"]
    assert (counter, per) == ("hash_join_probe", 1)
    assert S.trace_check(_trace(10, 4, 3), "hash_join_probe_kernel",
                         4 * per)[3] == ""
    # every call has its record, but two launches counted by the wrapper
    # are not in the trace at all: the matched records fall short
    device, host, matched, why = S.trace_check(
        _trace(10, 2, 3), "hash_join_probe_kernel", 4)
    assert (device, host, matched) == (13, 13, 2)
    assert why == "2 hash_join_probe_kernel records for 4 counted launches"


def test_every_counted_kernel_names_a_counter():
    from spark_rapids_tpu_torch.ops import cuda_kernels as CK
    assert {c for c, _per in S.COUNTED.values()} == set(CK.launches)
    # the radix launcher runs three kernels a counted call
    assert S.COUNTED["radix_"] == ("radix_ranks", 3)
