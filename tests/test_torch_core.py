"""The port's small modules against the JAX reference, and its import rules.

Constants, ``ChunkBatch``, planners, synthetic corpora and the liblz4 oracle
of ``tpucomp_torch`` against their ``tpucomp`` originals on the same numpy
inputs (exact equality: all values are integers or bytes); plus the package's
rules: it imports neither ``jax`` nor ``tpucomp``, its entry points default
to the card and raise without one, and its kernel paths refuse CPU tensors.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tpucomp.chunk as ref_chunk
import tpucomp.constants as ref_constants
import tpucomp.utils.synth as ref_synth

import tpucomp_torch.chunk as chunk
import tpucomp_torch.constants as constants
from tpucomp_torch import batched, logging as tlog
from tpucomp_torch.interop import cpu as interop
from tpucomp_torch.ops.cuda import (_build, lz4_decode2, lz4_encode2, snappy_decode,
                                    snappy_encode2)
from tpucomp_torch.utils import synth

REPO = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------- constants ---

@pytest.mark.parametrize("name", ["REQUIRED_ALIGNMENT", "MAX_ALLOWED_CHUNK_SIZE",
                                  "DEFAULT_CHUNK_SIZE", "CASCADED_DEFAULT_SUBCHUNK"])
def test_constant_values_equal_reference(name):
    assert getattr(constants, name) == getattr(ref_constants, name)


@pytest.mark.parametrize("enum", ["Status", "ElementType"])
def test_enum_members_equal_reference(enum):
    ours, ref = getattr(constants, enum), getattr(ref_constants, enum)
    assert [(m.name, int(m)) for m in ours] == [(m.name, int(m)) for m in ref]


def test_element_type_properties_equal_reference():
    for m in constants.ElementType:
        r = ref_constants.ElementType[m.name]
        assert (m.nbytes, m.np_dtype, m.is_signed) == (r.nbytes, r.np_dtype, r.is_signed)
    assert constants.element_type_from_name("int") == constants.ElementType.INT
    with pytest.raises(ValueError):
        constants.element_type_from_name("float")


# -------------------------------------------------------------- ChunkBatch ---

def _same(ours: chunk.ChunkBatch, ref: ref_chunk.ChunkBatch):
    assert ours.data.dtype == torch.uint8 and ours.sizes.dtype == torch.int32
    assert np.array_equal(ours.data.numpy(), np.asarray(ref.data))
    assert np.array_equal(ours.sizes.numpy(), np.asarray(ref.sizes))


BUFS = {
    "empty": b"",
    "short": b"abc",
    "exact": bytes(range(256)) * 4,
    "ragged": synth.mixed_corpus(3000, seed=1).tobytes(),
}


@pytest.mark.parametrize("chunk_size,max_b", [(256, None), (100, None), (64, 100)])
@pytest.mark.parametrize("buf", list(BUFS))
def test_from_bytes_equals_reference(buf, chunk_size, max_b):
    ours = chunk.ChunkBatch.from_bytes(BUFS[buf], chunk_size, max_b, device="cpu")
    _same(ours, ref_chunk.ChunkBatch.from_bytes(BUFS[buf], chunk_size, max_b))


CHUNK_LISTS = {
    "with_empty": [b"hello", b"", b"world!!!!", b""],
    "one_empty": [b""],
    "numpy": [np.arange(13, dtype=np.uint8), np.zeros(9, np.uint8)],
    "none": [],
}


@pytest.mark.parametrize("chunks", list(CHUNK_LISTS))
def test_from_chunks_equals_reference(chunks):
    ours = chunk.ChunkBatch.from_chunks(CHUNK_LISTS[chunks], device="cpu")
    ref = ref_chunk.ChunkBatch.from_chunks(CHUNK_LISTS[chunks])
    _same(ours, ref)
    assert ours.chunk_list() == ref.chunk_list()
    assert ours.to_bytes() == ref.to_bytes()
    assert int(ours.total_bytes) == int(ref.total_bytes)


def test_from_chunks_rejects_oversize():
    with pytest.raises(ValueError):
        chunk.ChunkBatch.from_chunks([b"x" * 20], max_chunk_bytes=8, device="cpu")


def test_empty_equals_reference():
    _same(chunk.ChunkBatch.empty(3, 16, device="cpu"), ref_chunk.ChunkBatch.empty(3, 16))


def _dirty_batch():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (5, 24), dtype=np.uint8)   # nonzero padding
    sizes = np.array([24, 0, 7, 13, 1], np.int32)
    return data, sizes


@pytest.mark.parametrize("method", ["with_padding_zeroed", "compact"])
def test_transforms_equal_reference(method):
    data, sizes = _dirty_batch()
    ours = getattr(chunk.ChunkBatch.from_numpy(data, sizes, device="cpu"), method)()
    ref = getattr(ref_chunk.ChunkBatch(data=jnp.asarray(data), sizes=jnp.asarray(sizes)),
                  method)()
    if method == "compact":
        for o, r in zip(ours, ref):
            assert np.array_equal(o.numpy(), np.asarray(r))
    else:
        _same(ours, ref)


def test_numpy_carry_round_trip():
    data, sizes = _dirty_batch()
    cb = chunk.ChunkBatch.from_numpy(data, sizes, device="cpu")
    d, s = cb.to_numpy()
    assert np.array_equal(d, data) and np.array_equal(s, sizes)
    assert (cb.num_chunks, cb.max_chunk_bytes) == (5, 24)


PAGED = b"".join(len(p).to_bytes(8, "little") + p for p in (b"abc", b"", b"defgh")) \
    + (99).to_bytes(8, "little") + b"short"


@pytest.mark.parametrize("args", [(0, 64), (1000, 256), (1024, 256), (5, 10)])
def test_plan_chunks_equals_reference(args):
    assert chunk.plan_chunks(*args) == ref_chunk.plan_chunks(*args)


def test_plan_chunks_page_prefixed_equals_reference():
    assert chunk.plan_chunks_page_prefixed(PAGED) == ref_chunk.plan_chunks_page_prefixed(PAGED)


# ------------------------------------------------------ device and backends ---

def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunk.ChunkBatch.from_bytes(b"abcdefgh", 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunk.ChunkBatch.empty(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunk.ChunkBatch.from_numpy(np.zeros((1, 8), np.uint8), np.zeros(1, np.int32))


def test_kernel_paths_refuse_cpu_tensors():
    cb = chunk.ChunkBatch.from_bytes(b"abcdefgh" * 4, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("lz4", cb, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        batched.decompress("lz4", cb, 16, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        lz4_decode2.decompress_batch(cb.data, cb.sizes, 16)
    with pytest.raises(ValueError, match="CUDA"):
        lz4_encode2.compress_batch(cb.data, cb.sizes, 64)
    with pytest.raises(ValueError, match="CUDA"):
        batched.compress("snappy", cb, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        snappy_decode.decompress_batch(cb.data, cb.sizes, 16)
    with pytest.raises(ValueError, match="CUDA"):
        snappy_encode2.compress_batch(cb.data, cb.sizes, 64)


def test_unported_paths_raise_not_implemented():
    cb = chunk.ChunkBatch.from_bytes(b"abcdefgh" * 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batched.compress("lz4", cb, backend="xla")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batched.get_decompress_size("lz4", cb)
    with pytest.raises(NotImplementedError, match="formats/snappy.py"):
        batched.decompress("snappy", cb, 16, backend="xla")
    with pytest.raises(ValueError, match="unknown backend"):
        batched.decompress("lz4", cb, 16, backend="pallas")
    with pytest.raises(ValueError, match="unknown format"):
        batched.compress("zstd", cb)


def test_api_parity_shims():
    assert batched.formats() == ["lz4", "snappy"]
    assert batched.compress_get_temp_size("lz4", 10, 65536) == 0
    assert batched.decompress_get_temp_size("lz4", 10, 65536) == 0
    assert batched.compress_get_temp_size_ex("lz4", 10, 65536, 1 << 20) == 0
    assert batched.decompress_get_temp_size_ex("lz4", 10, 65536, 1 << 20) == 0
    assert batched.compress_get_max_output_chunk_size("lz4", 65536) == 66560


def test_api_call_logging(monkeypatch, capsys):
    monkeypatch.setenv("TPUCOMP_LOG_LEVEL", "3")
    monkeypatch.setenv("TPUCOMP_LOG_FILE", "stdout")
    tlog.reset_logging_config()
    try:
        cb = chunk.ChunkBatch.from_bytes(b"abcdefgh" * 4, 16, device="cpu")
        batched.compress("lz4", cb)
    finally:
        monkeypatch.delenv("TPUCOMP_LOG_LEVEL")
        tlog.reset_logging_config()
    assert "batched.lz4.compress(num_chunks=2" in capsys.readouterr().out


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_dir_is_in_the_checkout():
    d = _build.build_dir()
    assert d.parent == REPO / "build" / "tpucomp_torch"
    assert d == _build.build_dir()   # a pure function of the sources
    assert {f"{k}.cu" for k in _build.KERNELS} <= {p.name for p in _build.CSRC.iterdir()}


# ------------------------------------------------------------ import rules ---

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|tpucomp)(?:[.\s]|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "tpucomp_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    hits = _IMPORT.findall((REPO / path).read_text())
    assert not hits, f"{path} imports {hits}"


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, tpucomp_torch, tpucomp_torch.batched, tpucomp_torch.formats, "
            "tpucomp_torch.ops.cuda.lz4_decode2, tpucomp_torch.ops.cuda.lz4_encode2, "
            "tpucomp_torch.ops.cuda.snappy_decode, tpucomp_torch.ops.cuda.snappy_encode2, "
            "tpucomp_torch.formats.snappy, tpucomp_torch.formats.crc32, "
            "tpucomp_torch.manager, tpucomp_torch.utils.synth, tpucomp_torch.interop.cpu\n"
            "tpucomp_torch.batched.formats()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpucomp')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


# ------------------------------------------------------- synth and oracle ---

@pytest.mark.parametrize("fn,size,seed", [
    ("mixed_corpus", 30000, 0), ("mixed_corpus", 4097, 42), ("mortgage_like", 20000, 42),
    ("text_like", 12345, 3), ("runs", 5000, 1), ("gen_data", 999, 2)])
def test_synth_equals_reference(fn, size, seed):
    args = (15, size) if fn == "gen_data" else (size,)
    ours = getattr(synth, fn)(*args, seed=seed)
    assert ours.tobytes() == getattr(ref_synth, fn)(*args, seed=seed).tobytes()


def test_liblz4_oracle_round_trip():
    if not interop.available()["lz4"]:
        pytest.skip("liblz4 is not installed")
    raw = synth.mixed_corpus(10000, seed=2).tobytes()
    for hc in (None, 9):
        assert interop.lz4_decompress(interop.lz4_compress(raw, hc), len(raw)) == raw
