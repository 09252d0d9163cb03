"""The port's Manager (HLIF) and CRC32 against the JAX reference, on the CPU.

* ``crc32_batch`` equals ``binascii.crc32`` and ``tpucomp.formats.crc32``.
* The port's frames are byte-identical to the reference Manager's (lz4 without
  checksums, snappy with ``COMPUTE_AND_VERIFY``), with the reference set to
  its kernel encoders and decoders (run in interpret mode here), as
  ``tests/test_manager.py::test_frame_round_trip_through_pallas_backends``
  does; each package decompresses the other's frames, and a truncated frame
  gives the reference's status.
* The checksum cases of ``tests/test_manager.py``, run on the port.

Tolerance: exact equality (frame bytes, buffers, CRC words, statuses).  In
the reference Manager's frames the CRC words come from ``binascii.crc32``
through a host callback: its own ``crc32_batch`` costs some 15 s of compile
per shape, and the first test holds it equal to ``binascii`` (and to the
port) on its own.  All reference calls run once, in the module fixture.
"""
import binascii

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpucomp.formats.crc32 as ref_crc32
import tpucomp.manager as ref_manager

from tpucomp_torch import manager
from tpucomp_torch.constants import ElementType, Status
from tpucomp_torch.formats import crc32
from tpucomp_torch.formats.lz4 import LZ4Opts
from tpucomp_torch.manager import ChecksumPolicy, Manager, create_manager
from tpucomp_torch.utils import synth

CRC_SIZES = [0, 1, 3, 4, 5, 4095, 4096, 65536]
DATA = synth.mixed_corpus(24_000, seed=17).tobytes()
CHUNK = 4096
FRAMES = {  # name -> (format, policy)
    "lz4_no_checksums": ("lz4", ChecksumPolicy.NO_COMPUTE_NO_VERIFY),
    "snappy_checksums": ("snappy", ChecksumPolicy.COMPUTE_AND_VERIFY),
}


def _host_crc32(data, sizes):
    """``crc32_batch`` through ``binascii`` (a host callback inside jit)."""
    def crcs(d, s):
        return np.array([binascii.crc32(d[i, :s[i]].tobytes()) for i in range(len(s))],
                        np.uint32)
    return jax.pure_callback(crcs, jax.ShapeDtypeStruct(sizes.shape, jnp.uint32),
                             data, sizes)


def _port(fmt, policy=ChecksumPolicy.NO_COMPUTE_NO_VERIFY, chunk=CHUNK, **kw):
    return Manager(fmt, chunk, checksum_policy=policy, device="cpu", **kw)


def _truncated(frame: bytes) -> bytes:
    return frame[:len(frame) - 700]


@pytest.fixture(scope="module")
def results():
    """Every reference call of this file, once, beside the port's."""
    rng = np.random.default_rng(4)
    crc_in = rng.integers(0, 256, (len(CRC_SIZES), 65536), dtype=np.uint8)
    crc_sizes = np.array(CRC_SIZES, np.int32)
    res = {"crc": (crc_in, crc_sizes,
                   np.asarray(ref_crc32.crc32_batch(jnp.asarray(crc_in),
                                                    jnp.asarray(crc_sizes))),
                   crc32.crc32_batch(torch.from_numpy(crc_in),
                                     torch.from_numpy(crc_sizes)).numpy())}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUCOMP_DECODE_BACKEND", "pallas")
        mp.setenv("TPUCOMP_ENCODE_BACKEND", "pallas")
        mp.setattr(ref_crc32, "crc32_batch", _host_crc32)
        for name, (fmt, policy) in FRAMES.items():
            ref_frame = np.asarray(ref_manager.Manager(
                fmt, CHUNK, checksum_policy=int(policy)).compress(DATA)).tobytes()
            port_frame = _port(fmt, policy).compress(DATA).numpy().tobytes()
            res[name] = {"ref_frame": ref_frame, "port_frame": port_frame}
        # the reference reads the port's snappy frame, whole and truncated
        frames = res["snappy_checksums"]
        for key, frame in (("ref_reads_port", frames["port_frame"]),
                           ("ref_truncated", _truncated(frames["port_frame"]))):
            m = ref_manager.create_manager(frame)
            cfg = m.configure_decompression(frame)
            out = np.asarray(m.decompress(frame, cfg)).tobytes()
            frames[key] = (out, int(cfg.get_status()))
    return res


# ------------------------------------------------------------------ crc32 ---

@pytest.mark.parametrize("size", CRC_SIZES)
def test_crc32_equals_binascii_and_reference(results, size):
    data, sizes, ref, port = results["crc"]
    i = CRC_SIZES.index(size)
    assert int(port[i]) == binascii.crc32(data[i, :size].tobytes()) == int(ref[i])


@pytest.mark.parametrize("cap", [1, 3, 4, 5, 8, 1000, 4097])
def test_crc32_ignores_bytes_past_size(cap):
    rng = np.random.default_rng(cap)
    data = rng.integers(0, 256, (5, cap), dtype=np.uint8)     # garbage past size
    sizes = np.array([0, 1, cap // 2, cap - 1, cap], np.int32)
    got = crc32.crc32_batch(torch.from_numpy(data), torch.from_numpy(sizes))
    assert got.dtype == torch.int64
    assert got.tolist() == [binascii.crc32(data[i, :s].tobytes())
                            for i, s in enumerate(sizes)]


# ----------------------------------------------------------------- frames ---

@pytest.mark.parametrize("name", list(FRAMES))
def test_frames_equal_reference(results, name):
    f = results[name]
    assert f["port_frame"] == f["ref_frame"]


@pytest.mark.parametrize("name", list(FRAMES))
def test_port_reads_reference_frames(results, name):
    frame = results[name]["ref_frame"]
    m = create_manager(frame, device="cpu")
    assert (m.format, m.chunk_size) == (FRAMES[name][0], CHUNK)
    cfg = m.configure_decompression(frame)
    out = m.decompress(frame, cfg)
    assert cfg.get_status() == Status.SUCCESS
    assert out.dtype == torch.uint8 and bytes(out.numpy()) == DATA


def test_reference_reads_port_frames(results):
    out, status = results["snappy_checksums"]["ref_reads_port"]
    assert (out, status) == (DATA, Status.SUCCESS)


def test_truncated_frame_gives_reference_status(results):
    frame = _truncated(results["snappy_checksums"]["port_frame"])
    m = create_manager(frame, device="cpu")
    cfg = m.configure_decompression(frame)
    out = m.decompress(frame, cfg)
    ref_out, ref_status = results["snappy_checksums"]["ref_truncated"]
    assert ref_status != Status.SUCCESS
    assert (bytes(out.numpy()), int(cfg.get_status())) == (ref_out, ref_status)


def test_frame_without_crc_tables():
    """The checksummed frame minus its CRC tables is the frame a manager
    without checksums writes, and reads back the same bytes."""
    frame = _port("snappy", ChecksumPolicy.COMPUTE_AND_VERIFY).compress(DATA).numpy()
    plain = _port("snappy").compress(DATA).numpy()
    n = -(-len(DATA) // CHUNK)
    head = frame[:manager.HEADER_BYTES].copy()
    head[28:32] = 0                                           # checksum_mode
    head[32:40] = np.frombuffer(np.uint64(len(frame) - 8 * n).tobytes(), np.uint8)
    stripped = np.concatenate([head, frame[56:56 + 4 * n], frame[56 + 12 * n:]])
    assert stripped.tobytes() == plain.tobytes()
    assert bytes(_port("snappy").decompress(stripped).numpy()) == DATA


# -------------------------------------------------------------- checksums ---

@pytest.mark.parametrize("fmt", ["lz4", "snappy"])
class TestChecksums:
    """``tests/test_manager.py::TestChecksums`` on the port."""

    def frame_with(self, fmt, policy, data=DATA[:20_000]):
        mgr = _port(fmt, policy, chunk=8192)
        return mgr, mgr.compress(data), data

    def test_compute_and_verify_roundtrip(self, fmt):
        mgr, frame, data = self.frame_with(fmt, ChecksumPolicy.COMPUTE_AND_VERIFY)
        dcfg = mgr.configure_decompression(frame)
        out = mgr.decompress(frame, dcfg)
        assert dcfg.get_status() == Status.SUCCESS
        assert bytes(out.numpy()) == data

    def test_corruption_detected(self, fmt):
        mgr, frame, data = self.frame_with(fmt, ChecksumPolicy.COMPUTE_AND_VERIFY)
        bad = frame.clone()
        bad[len(bad) // 2] ^= 0xFF  # flip a payload byte
        dcfg = mgr.configure_decompression(bad)
        mgr.decompress(bad, dcfg)
        assert dcfg.get_status() == Status.ERROR_BAD_CHECKSUM

    def test_verify_missing_checksums(self, fmt):
        frame = _port(fmt, chunk=8192).compress(DATA[:10_000])
        mgr_v = _port(fmt, ChecksumPolicy.COMPUTE_AND_VERIFY, chunk=8192)
        dcfg = mgr_v.configure_decompression(frame)
        mgr_v.decompress(frame, dcfg)
        assert dcfg.get_status() == Status.ERROR_CANNOT_VERIFY_CHECKSUMS

    def test_verify_if_present_without_checksums_ok(self, fmt):
        data = DATA[:10_000]
        frame = _port(fmt, chunk=8192).compress(data)
        mgr_v = _port(fmt, ChecksumPolicy.NO_COMPUTE_AND_VERIFY_IF_PRESENT, chunk=8192)
        dcfg = mgr_v.configure_decompression(frame)
        out = mgr_v.decompress(frame, dcfg)
        assert dcfg.get_status() == Status.SUCCESS
        assert bytes(out.numpy()) == data

    def test_factory_auto_verifies_when_present(self, fmt):
        mgr, frame, data = self.frame_with(fmt, ChecksumPolicy.COMPUTE_AND_NO_VERIFY)
        mgr2 = create_manager(frame, device="cpu")
        assert mgr2.checksum_policy == ChecksumPolicy.NO_COMPUTE_AND_VERIFY_IF_PRESENT
        dcfg = mgr2.configure_decompression(frame)
        out = mgr2.decompress(frame, dcfg)
        assert dcfg.get_status() == Status.SUCCESS
        assert bytes(out.numpy()) == data


# ------------------------------------------------------------------ misc ---

@pytest.mark.parametrize("fmt", ["lz4", "snappy"])
def test_empty_input(fmt):
    frame = _port(fmt, chunk=65536).compress(b"")
    mgr2 = create_manager(frame, device="cpu")
    cfg = mgr2.configure_decompression(frame)
    assert cfg.num_chunks == 1 and cfg.decomp_data_size == 0
    assert bytes(mgr2.decompress(frame, cfg).numpy()) == b""
    assert cfg.get_status() == Status.SUCCESS


def test_inputs_and_outputs_as_tensors():
    mgr = _port("lz4", chunk=8192)
    for data in (DATA[:9000], np.frombuffer(DATA[:9000], np.uint8),
                 torch.frombuffer(bytearray(DATA[:9000]), dtype=torch.uint8)):
        frame = mgr.compress(data)
        assert frame.dtype == torch.uint8 and frame.device.type == "cpu"
        assert mgr.get_compressed_output_size(frame) == frame.numel()
        assert bytes(mgr.decompress(frame.numpy().tobytes()).numpy()) == DATA[:9000]


def test_compression_config_host_resident():
    cfg = _port("lz4", chunk=8192).configure_compression(50_000)
    assert isinstance(cfg, manager.CompressionConfig)
    assert cfg.num_chunks == -(-50_000 // 8192)


def test_lz4_opts_survive_factory():
    opts = LZ4Opts(ElementType.INT)
    frame = Manager("lz4", 8192, opts=opts, device="cpu").compress(DATA[:8000])
    assert create_manager(frame, device="cpu").opts == opts


def test_not_a_frame():
    with pytest.raises(ValueError, match="bad magic"):
        create_manager(b"garbage bytes that are not a frame header......", device="cpu")


def test_unported_formats_and_default_device(monkeypatch):
    with pytest.raises(ValueError, match="unknown format"):
        Manager("deflate", device="cpu")
    with pytest.raises(ValueError, match="unknown format"):
        Manager("brotli", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Manager("lz4")


def test_bucket_chunk_cap_equals_reference():
    for raw in (0, 1, 1024, 1025, 70000):
        assert manager._bucket_chunk_cap(raw) == ref_manager._bucket_chunk_cap(raw)
