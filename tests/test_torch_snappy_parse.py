"""The Snappy parse kernel's plain pieces against the serial walk, on the CPU.

Row 6 (``csrc/snappy_decode.cu``'s parse kernel) decodes a chunk without
walking it: every position gets the length its element would have
(``snappy_decode.element_lengths_plain``), the chain of element starts
follows from those lengths (each block of 128 positions' last element on
the chain from every position, by pointer jumping: ``block_leavers_plain``;
then from leaver to leaver: ``chain_plain``), the status from a prefix sum
of the output lengths and the copies' offset checks, with the tail past the
padded row walked in skipped cycles (``status_plain``), and the bytes from
each output byte's source, resolved by pointer jumping (``sources_plain``);
``decode_chunk_parse_plain`` composes them.  Here they are held against the
walk ``snappy_decode._decode_chunk`` (its ``trace`` gives the element starts
and output offsets it visits) on ``tests/snappy_stress.py``'s streams at
out_caps 65536, 1000 and 66560.  No reference call: the CPU tests of
``tests/test_torch_snappy.py`` hold the walk against the reference.
Tolerance: exact (positions, offsets, statuses, sizes, bytes).
"""
import numpy as np
import pytest

import snappy_stress as ss
from tpucomp_torch.constants import Status
from tpucomp_torch.ops.cuda import snappy_decode as sd

OK = int(Status.SUCCESS)


@pytest.fixture(scope="module")
def rows():
    cb, names = ss.batch()
    out = {"names": names, "rows": [cb.data[i].numpy().tobytes() for i in range(cb.num_chunks)],
           "csizes": cb.sizes.tolist(), "walks": {}}
    for oc in ss.OUT_CAPS:
        walks = []
        for row, cs in zip(out["rows"], out["csizes"]):
            trace = []
            walks.append((*sd._decode_chunk(row, cs, oc, trace), trace))
        out["walks"][oc] = walks
    out["lengths"] = [sd.element_lengths_plain(r, c) for r, c in zip(out["rows"], out["csizes"])]
    out["chains"] = [sd.chain_plain(*x) for x in out["lengths"]]
    return out


def test_stress_rows_cover_their_cases(rows):
    """Each case the stress streams are for decides some row: every extra
    length byte count, copy-4, an offset equal to the output before it,
    every period below 64, a tag read from the word before it, csizes past
    the row (one decodes through the tail), every preamble error, too big,
    tags past position 65,535, both statuses of the walk."""
    walks = rows["walks"][ss.CHUNK]
    st = dict(zip(rows["names"], [w[2] for w in walks]))
    seen = set()
    for name, row, cs, (out, size, status, trace) in zip(rows["names"], rows["rows"],
                                                       rows["csizes"], walks):
        w, wpad = sd._words(row)
        ip = np.array([t[0] for t in trace], np.int64)
        op = np.array([t[1] for t in trace], np.int64)
        e = sd._elements(w, wpad, ip, cs)
        tag = w[4 * np.minimum(ip >> 2, wpad // 4 - 2) + (ip & 3)]
        copy = (e["lit"] < 0) & e["ok"]
        seen |= {f"extra {min(k - 59, 4)}" for k in (tag[e["lit"] >= 0] >> 2).tolist() if k >= 60}
        if np.any((tag & 3 == 3) & copy & (e["off"] <= op)):
            seen.add("copy-4")
        if np.any(copy & (e["off"] == op)):
            seen.add("off == op")
        if status == OK:
            seen |= {f"period {k}" for k in e["off"][copy & (e["off"] < np.minimum(e["out"], 64))]
                     .tolist()}
        if np.any(ip >= wpad - 4):
            seen.add("tag from the word before")
        if np.any(ip > 65535):
            seen.add("past 65535")
        if cs > wpad and status == OK:
            seen.add("decodes past wpad")
    assert {f"extra {k}" for k in (1, 2, 3, 4)} | {f"period {p}" for p in range(1, 64)} <= seen
    assert {"copy-4", "off == op", "tag from the word before", "past 65535",
            "decodes past wpad"} <= seen
    assert st["off_op_plus1"] == st["lit_bit31"] == st["pre_5_bytes"] == 12
    assert st["too_big"] == 15 and st["tail_ok"] == st["incompressible"] == OK


@pytest.mark.parametrize("out_cap", ss.OUT_CAPS)
def test_chain_from_element_lengths_is_the_walks(rows, out_cap):
    """The chain through the per-position lengths visits the walk's element
    starts inside the padded row (as far as the walk goes: it stops once its
    output passes out_cap + 1) and leaves it where the walk does."""
    for name, (starts, end, at), walk in zip(rows["names"], rows["chains"],
                                             rows["walks"][out_cap]):
        ips = [ip for ip, _ in walk[3]]
        inside = [ip for ip in ips if ip < rows["lengths"][rows["names"].index(name)][1]]
        assert starts[:len(inside)] == inside[:len(starts)], name
        if len(ips) > len(starts) and end != "bad":
            assert ips[len(starts)] == at, name


def test_block_leavers_are_each_blocks_last_element(rows):
    """Pointer jumping inside the blocks of 128 positions gives, from every
    position, the last element of its block on the chain from there (or the
    failing element's mark), as a chase from that position finds it."""
    n = 0
    for name, (pre_len, np_, d) in zip(rows["names"], rows["lengths"]):
        leav = sd.block_leavers_plain(pre_len, np_, d)
        for x in range(pre_len, min(np_, pre_len + 3000)):
            b0, y = x & ~(sd.BLOCK - 1), x
            while True:
                if d[y - pre_len] == 0:
                    want = -1
                    break
                z = y + int(d[y - pre_len])
                if z >= b0 + sd.BLOCK or z >= np_:
                    want = y - b0
                    break
                y = z
            assert leav[x] == want, (name, x)
            n += 1
    assert n > 20000


@pytest.mark.parametrize("out_cap", ss.OUT_CAPS)
def test_status_from_the_scan_is_the_walks(rows, out_cap):
    """The status and size from the prefix sum of output lengths (and the
    tail walk past the row) are the walk's; the sum's offsets are the walk's
    op at every element it visits."""
    for i, name in enumerate(rows["names"]):
        out, size, status, trace = rows["walks"][out_cap][i]
        got = sd.status_plain(rows["rows"][i], rows["csizes"][i], out_cap, *rows["chains"][i])
        assert got[:2] == (status, size), name
        ops = got[2].tolist()
        assert [op for _, op in trace][:len(ops)] == ops[:len(trace)], name


def test_tail_walk_skips_to_the_walks_status(rows):
    """Past wpad the kernel skips whole cycles of elements: the status is
    still the walk's for csizes around the tail row's end and out_caps
    around its total (the skip bounded by csize, then by out_cap + 1)."""
    i = rows["names"].index("tail_ok")
    row, cs = rows["rows"][i], rows["csizes"][i]
    total = rows["walks"][ss.CHUNK][i][1]
    seen = set()
    for dc in (-3, -2, -1, 0, 1, 2, 22, 4096):
        for oc in (total - 1, total, total + 1, ss.CHUNK):
            want = sd._decode_chunk(row, cs + dc, oc)
            got = sd.decode_chunk_parse_plain(row, cs + dc, oc)
            assert (bytes(got[0]), got[1], got[2]) == (bytes(want[0]), want[1], want[2]), (dc, oc)
            seen.add(want[2])
    assert seen == {OK, 12, 15}


@pytest.mark.parametrize("out_cap", [ss.CHUNK, ss.CHUNK + 1024])
def test_pointer_jumped_sources_give_the_walks_bytes(rows, out_cap):
    """On every row that decodes, each output byte's source, jumped until
    it is a literal's, picks the walk's byte from the window, within 16
    rounds at 64 KiB."""
    n = 0
    for i, name in enumerate(rows["names"]):
        out, size, status, _ = rows["walks"][out_cap][i]
        if status != OK:
            continue
        row, cs = rows["rows"][i], rows["csizes"][i]
        starts, end, at = rows["chains"][i]
        _, _, ops, row_total = sd.status_plain(row, cs, out_cap, starts, end, at)
        tail = at if end == "end" and at < cs else -1
        win, roots, rounds = sd.sources_plain(row, cs, size, starts, ops, tail, row_total)
        assert bytes(win[roots]) == bytes(out[:size]) and rounds <= 16, name
        n += 1
    assert n >= 12


@pytest.mark.parametrize("out_cap", ss.OUT_CAPS)
def test_parse_plain_is_the_walk(rows, out_cap):
    """The phases composed give the walk's rows, sizes and statuses."""
    for i, name in enumerate(rows["names"]):
        want = rows["walks"][out_cap][i]
        got = sd.decode_chunk_parse_plain(rows["rows"][i], rows["csizes"][i], out_cap)
        assert (bytes(got[0]), got[1], got[2]) == (bytes(want[0]), want[1], want[2]), name


def test_shapes_route_by_size():
    """The parse takes every shape the batched API makes at its 64 KiB chunk
    size; a larger out_cap or padded row takes the walk."""
    assert sd.parse_fits(ss.COMP_CAP, ss.CHUNK) and sd.parse_fits(8, 0)
    assert sd.parse_fits(sd.PARSE_MAX_COMP, 1) and not sd.parse_fits(sd.PARSE_MAX_COMP + 1, 1)
    assert not sd.parse_fits(ss.COMP_CAP, ss.CHUNK + 1)
