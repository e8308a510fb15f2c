"""The port's page decode (ops/parquet_decode.py) held against the JAX
package's: ``decode_page_cols`` (the single decode body) and
``decode_dictionary_page`` (one page of a multi-page chunk). The same numpy
inputs go through both. Tolerance: values and validity exact over the whole
capacity, padding and invalid slots included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spark_rapids_tpu.ops import parquet_decode as PD
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.ops import cuda_kernels as CK
from spark_rapids_tpu_torch.ops import parquet_decode as TPD


def _pack(idx: np.ndarray, bw: int) -> np.ndarray:
    """Little-endian bit-pack ``idx`` at ``bw`` bits into bytes."""
    bits = ((idx[:, None] >> np.arange(bw)) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little")


def _page(n: int, nd: int, null_frac: float, seed: int):
    """(def_levels, indices of present values, packed bytes, bit width)."""
    rng = np.random.default_rng(seed)
    dl = (rng.random(n) >= null_frac).astype(np.int32)
    n_present = int(dl.sum())
    bw = max(int(nd - 1).bit_length(), 1)
    idx = rng.integers(0, max(nd, 1), n_present)
    return dl, idx, _pack(idx, bw), bw


CASES = {
    # name: (n rows, dictionary, null fraction)
    "double_dict": (700, np.round(np.random.default_rng(1).uniform(
        -1e6, 1e6, 37), 2), 0.0),
    "double_dict_nulls": (700, np.round(np.random.default_rng(2).uniform(
        0, 1e5, 300), 2), 0.3),
    "long_dict_nulls": (1000, np.random.default_rng(3).integers(
        -2**40, 2**40, 5000), 0.1),
    "string_codes_nulls": (513, "strings", 0.25),
    "all_null_empty_dict": (64, np.zeros(0, np.float64), 1.0),
}


def _dictionary(spec):
    """Device dictionary for both packages: values, or for strings the rank
    array mapping file-order index → sorted code (as the scan builds it)."""
    if isinstance(spec, str):
        from spark_rapids_tpu_torch.ops.strings import sorted_dict_and_rank
        words = ["delta", "alpha", "echo", "bravo", "charlie", "", "zulu"]
        _, rank = sorted_dict_and_rank(words)
        return rank, np.int32, 0
    dt = spec.dtype
    return spec, dt, (0.0 if dt.kind == "f" else 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_page_cols_matches_jax(case):
    n, dspec, null_frac = CASES[case]
    dvals, want_dt, default = _dictionary(dspec)
    dl, idx, packed, bw = _page(n, len(dvals), null_frac, seed=len(case))
    n_present = int(dl.sum())
    cap = bucket_capacity(n)
    pcap = max(bucket_capacity(max(n_present, 1)), 8)
    bcap = max(bucket_capacity(max(len(packed), 1)), 8)
    is_string = isinstance(dspec, str)
    dh = np.zeros(cap, bool)
    dh[:n] = dl.astype(bool)

    jspec = PD.EncodedPageSpec(bw, pcap, bcap, cap, np.dtype(want_dt).name,
                               is_string, default, False, 0)
    ph = np.zeros(bcap, np.uint8)
    ph[:len(packed)] = packed
    jv, jm = PD.decode_page_cols(jspec, jnp.asarray(ph), jnp.asarray(dvals),
                                 jnp.asarray(dh), jnp.asarray(n_present,
                                                              jnp.int32),
                                 jnp.asarray(n, jnp.int32))

    tspec = TPD.EncodedPageSpec(bw, pcap, cap,
                                torch.from_numpy(np.zeros(0, want_dt)).dtype,
                                is_string, default, n_present)
    words = CK.bytes_to_words_u32(packed)
    tv, tm = TPD.decode_page_cols(tspec, torch.from_numpy(words),
                                  torch.from_numpy(np.asarray(dvals)),
                                  torch.from_numpy(dh), n)
    assert tv.numpy().dtype == np.asarray(jv).dtype
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c != "all_null_empty_dict"))
def test_decode_dictionary_page_matches_jax(case):
    n, dspec, null_frac = CASES[case]
    dvals, _, _ = _dictionary(dspec)
    dl, idx, packed, bw = _page(n, len(dvals), null_frac, seed=len(case) + 7)
    n_present = int(dl.sum())
    cap = bucket_capacity(max(n, 1))
    jv, jm = PD.decode_dictionary_page(packed, bw, n_present, dl,
                                       jnp.asarray(dvals), cap)
    tv, tm = TPD.decode_dictionary_page(packed, bw, n_present, dl,
                                        torch.from_numpy(np.asarray(dvals)),
                                        cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_expand_present_to_rows_matches_jax():
    rng = np.random.default_rng(5)
    present = rng.normal(size=128)
    dl = rng.random(128) < 0.6
    jv, jm = PD.expand_present_to_rows(jnp.asarray(present), jnp.asarray(dl),
                                       128)
    tv, tm = TPD.expand_present_to_rows(torch.from_numpy(present),
                                        torch.from_numpy(dl), 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
