"""The port's fused chunk decode and its radix kernels' plain paths held
against the JAX package on the CPU, with the same numpy inputs:

- ``chunk_to_device`` (host packing into one buffer, the page table, and
  ``chunk_decode``'s plain version) against the reference's
  ``chunk_to_device`` on synthetic chunks: v1 and v2 pages, pages with
  nulls, RLE runs mixed with bit-packed groups, every bit width 1..32,
  INT32 / INT64 / FLOAT / DOUBLE / BYTE_ARRAY dictionaries, single-page
  chunks, an all-null page with an empty dictionary, and capacities past
  the rows; and ``read_row_group_device`` against the reference's on a
  file written with v2 data pages and nulls;
- ``radix_ranks`` against ``pallas_kernels.radix_ranks`` (interpret mode, as
  tests/test_pallas.py runs it) at the q5-sparse hash build's shape (16,384
  ids over 4,096 lanes), ``radix_partition_permutation`` against the
  reference's and a stable argsort at 2, 9, 129 and 4,096 lanes, and
  ``hash_join_build``'s tables against the reference's at that shape.

Tolerance: exact (values, validity and dictionaries over the whole capacity;
integer ranks and permutations).
"""

import numpy as np
import jax.numpy as jnp
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.io import parquet_native as JPN
from spark_rapids_tpu.ops import pallas_kernels as PK
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.vector import bucket_capacity
from spark_rapids_tpu_torch.io import parquet_native as PN
from spark_rapids_tpu_torch.ops import cuda_kernels as CK

# physical type -> (numpy dtype of its dictionary, the spark type each
# package is handed: FLOAT is read as DOUBLE, the port having no FLOAT)
PHYSICAL = {"INT32": ("<i4", None, None), "INT64": ("<i8", None, None),
            "FLOAT": ("<f4", JT.DOUBLE, T.DOUBLE),
            "DOUBLE": ("<f8", None, None), "BYTE_ARRAY": (None, None, None)}


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bitpack(vals: np.ndarray, bw: int) -> bytes:
    bits = ((vals.astype(np.uint64)[:, None] >> np.arange(bw, dtype=np.uint64))
            & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little").tobytes()


def _hybrid(rng, n: int, bw: int, nd: int, mode: str):
    """(indices, RLE/bit-packed hybrid stream) of n dictionary indices: mostly
    inside the dictionary, some anywhere in [0, 2^bw) (the decode clamps
    them). ``mode``: "packed" (bit-packed groups only, in several segments),
    "rle" (runs only) or "mixed"."""
    top = 1 << bw
    idx = np.where(rng.random(n) < 0.9, rng.integers(0, max(nd, 1), n),
                   rng.integers(0, top, n, dtype=np.uint64)).astype(np.uint64)
    out, at = bytearray(), 0
    while at < n:
        left = n - at
        rle = mode == "rle" or (mode == "mixed" and rng.random() < 0.5)
        if rle:
            count = int(min(left, rng.integers(1, 40)))
            # a run's value fits bw bits and the reference's int32 decode
            v = int(rng.integers(0, min(top, 1 << 31)))
            idx[at:at + count] = v
            out += _varint(count << 1) + v.to_bytes((bw + 7) // 8, "little")
        else:
            # segments hold whole groups of 8; only the last may run short
            count = int(min(left, 8 * rng.integers(1, 12)))
            groups = -(-count // 8)
            vals = np.zeros(groups * 8, np.uint64)
            vals[:count] = idx[at:at + count]
            out += _varint((groups << 1) | 1) + _bitpack(vals, bw)
        at += count
    return idx, bytes(out)


def _page(rng, n: int, bw: int, nd: int, mode: str, null_frac: float,
          version: int):
    """One data page as ``read_chunk_pages`` yields it, for both packages:
    (num_values, def levels, bit width, page bytes, values offset) and the
    bytes the hybrid parse starts from. A v1 page carries its def-level
    section ahead of the bit-width byte; a v2 page's values start with it."""
    dl = (rng.random(n) >= null_frac).astype(np.int32)
    n_present = int(dl.sum())
    _, stream = _hybrid(rng, n_present, bw, nd, mode) if n_present else \
        (None, b"")
    head = (b"\x05\x00\x00\x00" + bytes(rng.integers(0, 256, 5)
                                        .astype(np.uint8))
            if version == 1 else b"")
    page_bytes = head + bytes([bw]) + stream
    return n, dl, bw, page_bytes, len(head), n_present


def _chunks(physical: str, dict_values, specs):
    """The same synthetic chunk as each package's ChunkPages."""
    jsegs, tsegs = [], []
    for (n, dl, bw, page_bytes, off, n_present) in specs:
        jsegs.append((n, dl, bw, page_bytes, off, JPN.parse_rle_hybrid(
            page_bytes, off + 1, len(page_bytes), bw, n_present)))
        tsegs.append((n, dl, bw, page_bytes, off, PN.parse_rle_hybrid(
            page_bytes, off + 1, len(page_bytes), bw, n_present)))
    total = sum(s[0] for s in specs)
    return (JPN.ChunkPages(physical, dict_values, jsegs, total),
            PN.ChunkPages(physical, dict_values, tsegs, total))


def _dictionary(rng, physical: str, nd: int):
    if physical == "BYTE_ARRAY":
        return [f"v{int(x):05d}" for x in rng.permutation(nd)]
    dt = PHYSICAL[physical][0]
    if dt[1] == "f":
        return np.round(rng.uniform(-1e6, 1e6, nd), 3).astype(dt)
    info = np.iinfo(np.dtype(dt))
    return rng.integers(info.min, info.max, nd, endpoint=True).astype(dt)


def _assert_same(physical, jpages, tpages, capacity):
    _, jtype, ttype = PHYSICAL[physical]
    jc = JPN.chunk_to_device(jpages, jtype, capacity)
    tc = PN.chunk_to_device(tpages, ttype, capacity, "cpu")
    jv, tv = np.asarray(jc.data), tc.data.numpy()
    assert tv.dtype == jv.dtype and tv.shape == (capacity,)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc.validity.numpy(),
                                  np.asarray(jc.validity))
    if physical == "BYTE_ARRAY":
        assert tc.dictionary.equals(jc.dictionary)
    return tc


PAGE_PLANS = [
    # (rows, mode, null fraction, page version)
    (700, "packed", 0.3, 1),
    (333, "mixed", 0.0, 2),
    (256, "rle", 0.0, 1),
    (1000, "packed", 0.0, 2),
    (129, "mixed", 0.2, 2),
]


@pytest.mark.parametrize("bw", list(range(1, 33)))
def test_chunk_decode_every_bit_width_matches_jax(bw):
    """A multi-page chunk at each bit width: v1 and v2 pages, nulls, RLE
    runs mixed with bit-packed groups, indices past the dictionary."""
    rng = np.random.default_rng(bw)
    physical = list(PHYSICAL)[bw % len(PHYSICAL)]
    nd = int(min(1 << bw, 300))
    dvals = _dictionary(rng, physical, nd)
    specs = [_page(rng, n, bw, nd, mode, nulls, version)
             for (n, mode, nulls, version) in PAGE_PLANS]
    jpages, tpages = _chunks(physical, dvals, specs)
    _assert_same(physical, jpages, tpages, bucket_capacity(jpages.num_values))


@pytest.mark.parametrize("layout", ["single_packed", "single_rle",
                                    "single_nulls", "multi"])
@pytest.mark.parametrize("physical", list(PHYSICAL))
def test_chunk_decode_each_type_matches_jax(physical, layout):
    rng = np.random.default_rng(len(physical) * 10 + len(layout))
    nd, bw = 37, 6
    dvals = _dictionary(rng, physical, nd)
    if layout == "single_packed":
        specs = [_page(rng, 900, bw, nd, "packed", 0.0, 1)]
    elif layout == "single_rle":
        specs = [_page(rng, 900, bw, nd, "rle", 0.0, 2)]
    elif layout == "single_nulls":
        specs = [_page(rng, 900, bw, nd, "packed", 0.4, 2)]
    else:
        specs = [_page(rng, n, bw, nd, mode, nulls, version)
                 for (n, mode, nulls, version) in PAGE_PLANS]
    jpages, tpages = _chunks(physical, dvals, specs)
    _assert_same(physical, jpages, tpages, bucket_capacity(jpages.num_values))


def test_chunk_decode_all_null_page_with_an_empty_dictionary():
    rng = np.random.default_rng(3)
    dvals = np.zeros(0, "<f8")
    specs = [_page(rng, 300, 1, 0, "packed", 1.0, 1)]
    jpages, tpages = _chunks("DOUBLE", dvals, specs)
    tc = _assert_same("DOUBLE", jpages, tpages, 512)
    assert not tc.validity.any()


def test_chunk_decode_all_null_page_among_others():
    rng = np.random.default_rng(4)
    dvals = _dictionary(rng, "INT64", 50)
    specs = [_page(rng, 200, 6, 50, "packed", 0.1, 1),
             _page(rng, 150, 6, 50, "packed", 1.0, 1),
             _page(rng, 90, 6, 50, "mixed", 0.5, 2)]
    jpages, tpages = _chunks("INT64", dvals, specs)
    _assert_same("INT64", jpages, tpages, 512)


@pytest.mark.parametrize("capacity", [1024, 4096])
def test_chunk_decode_pads_past_the_rows(capacity):
    """Rows past the chunk's take the default and are not valid, at a
    capacity well past the rows (the row group's bucket)."""
    rng = np.random.default_rng(capacity)
    dvals = _dictionary(rng, "BYTE_ARRAY", 20)
    specs = [_page(rng, 500, 5, 20, "mixed", 0.25, 1),
             _page(rng, 200, 5, 20, "packed", 0.0, 2)]
    jpages, tpages = _chunks("BYTE_ARRAY", dvals, specs)
    tc = _assert_same("BYTE_ARRAY", jpages, tpages, capacity)
    assert not tc.validity[700:].any() and not tc.data[700:].any()


def test_pack_chunk_layout():
    """The page table, the bit width 32 of host-decoded RLE pages, and one
    buffer whose views give back the words, def levels and dictionary."""
    rng = np.random.default_rng(9)
    dvals = _dictionary(rng, "INT64", 40)
    specs = [_page(rng, 100, 6, 40, "packed", 0.2, 1),
             _page(rng, 60, 6, 40, "rle", 0.0, 2),
             _page(rng, 80, 6, 40, "packed", 0.0, 1)]
    _, tpages = _chunks("INT64", dvals, specs)
    dictionary = torch.from_numpy(dvals)
    packed = PN.pack_chunk(tpages, dictionary, 256)
    words, table, defs, dict_t = PN.chunk_views(packed.buf, packed,
                                                torch.int64)
    rows = table.tolist()
    presents = [int(s[1].sum()) for s in specs]
    assert [r[0] for r in rows] == [0, 100, 160]
    assert [r[1] for r in rows] == [100, 60, 80]
    assert [r[4] for r in rows] == [6, 32, 6]
    assert [r[5] for r in rows] == presents
    assert [r[6] for r in rows] == [0, presents[0], presents[0] + 60]
    assert [r[7] for r in rows] == [int(presents[0] < 100), 0, 0]
    assert rows[1][3] == 60 and packed.n_rows == 240
    assert [r[2] for r in rows] == [0, rows[0][3], rows[0][3] + 60]
    assert words.numel() == sum(r[3] for r in rows)
    assert torch.equal(dict_t, dictionary)
    want_defs = np.concatenate([s[1] for s in specs]).astype(bool)
    np.testing.assert_array_equal(defs.numpy().astype(bool), want_defs)
    # the RLE page's words are its indices as the host decodes them
    n, dl, bw, page_bytes, off, n_present = specs[1]
    np.testing.assert_array_equal(
        words[rows[1][2]:rows[1][2] + 60].numpy(),
        PN.decode_rle_host(page_bytes, off + 1, len(page_bytes), bw, 60))
    # no nulls anywhere: no def-level section
    packed = PN.pack_chunk(PN.ChunkPages("INT64", dvals, tpages
                                         .index_segments[1:], 140),
                           dictionary, 256)
    assert packed.defs is None


def test_chunk_decode_checks_its_inputs():
    w = torch.zeros(8, dtype=torch.int32)
    page = (0, 8, 0, 8, 4, 8, 0, 0)
    d4 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        CK.chunk_decode(w.to(torch.int64), page, None, d4, 8, 8,
                        torch.int32, 0)
    with pytest.raises(TypeError):
        CK.chunk_decode(w, page[:7], None, d4, 8, 8, torch.int32, 0)
    with pytest.raises(ValueError):
        CK.chunk_decode(w, page, None, d4, 9, 8, torch.int32, 0)
    with pytest.raises(TypeError):   # the dictionary is in the column type
        CK.chunk_decode(w, page, None, torch.zeros(3, dtype=torch.float32),
                        8, 8, torch.float64, 0.0)
    with pytest.raises(TypeError):   # def levels must cover the rows
        CK.chunk_decode(w, page, torch.ones(4, dtype=torch.bool), d4, 8,
                        8, torch.int32, 0)
    dictionary = torch.arange(5, 21, dtype=torch.int32)
    CK.reset_launches()
    v, m = CK.chunk_decode(w, page, None, dictionary, 8, 16, torch.int32, -1)
    assert CK.launches["bitunpack128"] == 0     # CPU: the plain version
    assert m[:8].all() and not m[8:].any()
    assert (v[:8] == 5).all() and (v[8:] == -1).all()


def test_read_row_group_device_v2_pages_match_jax(tmp_path):
    """A file written with v2 data pages (levels outside the compressed
    values), nulls, tiny pages and two row groups, read through both
    packages' device decode."""
    rng = np.random.default_rng(12)
    n = 2500

    def nulls(a, frac):
        return pa.array(a, mask=rng.random(n) < frac)
    t = pa.table({
        "i64": nulls(rng.integers(-10**12, 10**12, n), 0.1),
        "i32": nulls(rng.integers(0, 300, n).astype(np.int32), 0.3),
        "d": nulls(np.round(rng.uniform(0, 100, n), 1), 0.0),
        "s": nulls(np.array(["x", "yy", "zzz", "a", ""])[
            rng.integers(0, 5, n)], 0.2),
    })
    path = str(tmp_path / "v2.parquet")
    pq.write_table(t, path, row_group_size=1300, data_page_size=300,
                   write_batch_size=50, data_page_version="2.0")
    pf = pq.ParquetFile(path)
    assert pf.metadata.num_row_groups == 2
    for rg in range(2):
        chunk = PN.read_chunk_pages(path, rg, 0, md=pf.metadata)
        assert len(chunk.index_segments) > 1
        jb = JPN.read_row_group_device(path, rg, None)
        tb = PN.read_row_group_device(path, rg, None, "cpu")
        assert jb.num_rows == tb.num_rows
        for name, jc, tc in zip(tb.schema.names, jb.columns, tb.columns):
            np.testing.assert_array_equal(tc.data.numpy(),
                                          np.asarray(jc.data), err_msg=name)
            np.testing.assert_array_equal(tc.validity.numpy(),
                                          np.asarray(jc.validity),
                                          err_msg=name)


# -- radix ranks and the partition permutation ------------------------------

def _hash_build_ids(rng, cap=16_384, lanes=4096, live=10_000):
    """The q5-sparse hash build's radix input: ``live`` bucket ids over
    ``lanes`` buckets, then the padding rows' id ``lanes``, past the domain."""
    ids = np.full(cap, lanes, np.int32)
    ids[:live] = rng.integers(0, lanes, live)
    return ids


@pytest.mark.parametrize("case", ["hash_build", "uniform_with_outside"])
def test_radix_ranks_matches_jax_at_the_hash_build_shape(case):
    rng = np.random.default_rng(len(case))
    if case == "hash_build":
        ids = _hash_build_ids(rng)
    else:
        ids = rng.integers(-2, 4096 + 2, 16_384).astype(np.int32)
    want_r, want_c = PK.radix_ranks(jnp.asarray(ids), 4096)
    got_r, got_c = CK.radix_ranks(torch.from_numpy(ids), 4096)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("lanes", [2, 9, 129, 4096])
def test_radix_partition_permutation_matches_jax_and_argsort(lanes):
    rng = np.random.default_rng(lanes)
    ids = rng.integers(0, lanes, 5000).astype(np.int32)
    CK.reset_launches()
    got = CK.radix_partition_permutation(torch.from_numpy(ids), lanes)
    assert CK.launches["radix_ranks"] == 0     # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.argsort(ids, kind="stable"))
    want = PK.radix_partition_permutation(jnp.asarray(ids), lanes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = CK.radix_partition_permutation_plain(torch.from_numpy(ids), lanes)
    assert torch.equal(plain, got)


def test_radix_partition_permutation_rejects_bad_input():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        CK.radix_partition_permutation(ids, 0)
    with pytest.raises(ValueError):
        CK.radix_partition_permutation(ids, CK.RADIX_MAX_PARTS + 1)
    with pytest.raises(TypeError):
        CK.radix_partition_permutation(ids.to(torch.int64), 4)
    assert CK.radix_partition_permutation(ids[:0], 0).numel() == 0


def test_hash_join_build_matches_jax_at_the_q5_sparse_shape():
    """The supplier build of q5-sparse at SF1: 10,000 sparse keys in a
    16,384-row batch, 4,096 buckets; the padding rows are not eligible."""
    rng = np.random.default_rng(5)
    keys = np.zeros(16_384, np.int64)
    keys[:10_000] = (rng.permutation(10_000).astype(np.int64) + 1) \
        * 1_000_003
    elig = np.arange(16_384) < 10_000
    nb = CK.hash_join_buckets(10_000)
    assert nb == 4096
    PK.set_mode(True)
    try:
        want = PK.hash_join_build(jnp.asarray(keys), jnp.asarray(elig), nb)
    finally:
        PK.set_mode(None)
    got = CK.hash_join_build(torch.from_numpy(keys), torch.from_numpy(elig),
                             nb)
    assert bool(got[2]) == bool(want[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
