"""Guards of the port's boundaries: no JAX and nothing of the JAX package,
no module-level Triton, CUDA and host builds that fail loudly, and no
plain-version fallback off the CPU."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu_torch import _build, native
from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

PORT_FILES = sorted((ROOT / "metalhuffman_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_and_decodes_without_jax():
    code = """
import sys
# any import of jax or of the JAX package now raises ImportError
sys.modules['jax'] = None
sys.modules['metalhuffman_tpu'] = None
import zlib
import numpy as np
import metalhuffman_tpu_torch
from metalhuffman_tpu_torch.models import frame_stream
from metalhuffman_tpu_torch.models.config import CodecConfig
frames = np.random.default_rng(0).integers(0, 256, (2, 16, 24), dtype=np.uint8)
stream = frame_stream.encode_frames_shared(frames)
blob = frame_stream.write_shared(stream, 2, 16, 24,
                                 source_crc32=zlib.crc32(frames.tobytes()))
out = metalhuffman_tpu_torch.decode_video(blob, "cpu")
assert (out == frames).all()
for bd in (4, 8):
    img = metalhuffman_tpu_torch.encode_image(frames[0], CodecConfig(block_dim=bd))
    assert (metalhuffman_tpu_torch.decode_image(img, device="cpu") == frames[0]).all()
from metalhuffman_tpu_torch import native
from metalhuffman_tpu_torch.ops import encode_cuda
payload = np.repeat(frames.ravel(), 2)[:64 * 23 + 17]
hybrid = encode_cuda.encode_symbols_hybrid(payload, device="cpu")
host = native.encode_symbols(payload)
assert (hybrid.code_bytes == host.code_bytes).all()
assert (hybrid.block_offsets == host.block_offsets).all()
# temporal with motion, a color video and a gray16 video
pan = np.stack([np.roll(frames[0], (i, -2 * i), (0, 1)) for i in range(5)])
mhvt = metalhuffman_tpu_torch.encode_video(
    pan, CodecConfig(temporal=True, motion=True, keyint=3))
assert mhvt[:4] == b"MHVT"
assert (metalhuffman_tpu_torch.decode_video(mhvt, "cpu") == pan).all()
rgb = np.stack([pan, pan // 2, 255 - pan], axis=-1)
mhtc = metalhuffman_tpu_torch.encode_color_video(rgb)
assert mhtc[:4] == b"MHTC"
assert (metalhuffman_tpu_torch.decode_color_video(mhtc, "cpu") == rgb).all()
from metalhuffman_tpu_torch.models import color
depth = pan.astype(np.uint16) * 16 + np.arange(24, dtype=np.uint16) * 99
g16 = color.encode_gray16_to_bytes(depth)
got = color.decode_gray16_from_bytes(g16, "cpu")
assert got.dtype == np.uint16 and (got == depth).all()
# the multi-GPU modules: every rank's local step in turn, assembled
from metalhuffman_tpu_torch.parallel import mesh, multihost, shard_encode
parts = [frame_stream.decode_shared_local(stream, 2, 16, 24, rank=r, world=3,
                                          device="cpu")[0] for r in range(3)]
assert (frame_stream.frames_from_shards(parts, 2, 16, 24).numpy() == frames).all()
assert shard_encode.symbol_range(2, 3, payload.size)[1] == payload.size
assert mesh.process_info() == (0, 1) and multihost.gather_blocks
assert not any(m == "jax" or m.startswith(("jax.", "metalhuffman_tpu."))
               or m == "metalhuffman_tpu" for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_module_level_triton(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"^(import|from)\s+triton\b", src, re.M)
    assert not re.search(
        r"^\s*(import|from)\s+metalhuffman_tpu\b(?!_torch)", src, re.M)
    assert not re.search(r"\bimport_module\(|__import__\(", src)


def test_chip_smoke_reaches_the_codec_only_through_the_port():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+metalhuffman_tpu\b(?!_torch)",
                         src, re.M)
    assert not re.search(r"^\s*(import|from)\s+bench\b", src, re.M)


def test_chip_smoke_frames_match_bench():
    for phase in (0, 7):
        np.testing.assert_array_equal(
            chip_smoke.synthetic_frame(24, 40, seed=0, phase=phase),
            bench.synthetic_frame(24, 40, seed=0, phase=phase))
    # taller and wider than the 2048x1536 photo, so both axes tile
    np.testing.assert_array_equal(chip_smoke.photo_frames(1544, 2056, 2),
                                  bench.photo_frames(1544, 2056, 2))


def test_build_targets_sm90a_under_build_dir():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build.BUILD_DIR == ROOT / "build" / "metalhuffman_tpu_torch"
    paths = {_build.library_path(name) for name in _build.KERNELS}
    assert len(paths) == len(_build.KERNELS)  # one library per kernel
    assert {p.parent for p in paths} == {_build.BUILD_DIR}
    assert native.library_path().parent == _build.BUILD_DIR
    assert all(src.suffix == ".cu" and src.is_file()
               for src in _build.KERNELS.values())
    assert _build.HEADERS.keys() == _build.KERNELS.keys()
    assert all(h.is_file() for hs in _build.HEADERS.values() for h in hs)
    for name, src in _build.KERNELS.items():
        assert f"mht_{name}(" in src.read_text()


def test_chip_smoke_reports_and_counts_every_kernel():
    # every built kernel has an entry in the kernels line and a launch count
    assert chip_smoke.KERNELS.keys() == _build.KERNELS.keys()
    chip_smoke.reset_launches()
    assert chip_smoke.read_launches() == chip_smoke.expect()
    assert all(e["source"] == f"metalhuffman_tpu_torch/csrc/{n}.cu"
               and (ROOT / e["replaces"].split(":")[0]).is_file()
               for n, e in chip_smoke.KERNELS.items())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_host_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.encode_symbols(np.arange(64, dtype=np.uint8))
    assert not (tmp_path / "build").exists()


def test_host_build_raises_with_the_compiler_error(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").iterdir())


def test_decode_images_off_cpu_raises_instead_of_plain():
    args = (torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(256, dtype=torch.uint8, device="meta"),
            (0,) * 16, (0,) * 16)
    before = dict(decode_cuda.launches)
    with pytest.raises(ValueError, match="meta"):
        decode_cuda.decode_images(*args, num_frames=1, bh=1, bw=2, delta=True)
    with pytest.raises(ValueError, match="meta"):
        decode_cuda.decode_blocks(*args, num_steps=16, delta=True)
    assert decode_cuda.launches == before


def test_encode_rows_off_cpu_raises_instead_of_plain():
    sym = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    tab = torch.zeros(256, dtype=torch.int32, device="meta")
    before = dict(encode_cuda.launches)
    with pytest.raises(ValueError, match="meta"):
        encode_cuda.encode_rows(sym, tab, wmax=4)
    assert encode_cuda.launches == before


def test_encode_rows_checks_its_inputs():
    sym = torch.zeros((2, 64), dtype=torch.uint8)
    tab = torch.zeros(256, dtype=torch.int32)
    for bad in (sym.int(), sym.view(-1), torch.zeros((2, 16), dtype=torch.uint8),
                torch.zeros((64, 2), dtype=torch.uint8).t()):
        with pytest.raises(ValueError, match="symbols"):
            encode_cuda.encode_rows(bad, tab, wmax=4)
    for bad in (tab.long(), tab[:255], torch.zeros(512, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="table"):
            encode_cuda.encode_rows(sym, bad, wmax=4)
    with pytest.raises(ValueError, match="table is on meta"):
        encode_cuda.encode_rows(sym, tab.to("meta"), wmax=4)
    with pytest.raises(ValueError, match="wmax"):
        encode_cuda.encode_rows(sym, tab, wmax=0)


def test_decode_images_checks_its_inputs():
    words = torch.zeros(8, dtype=torch.int32)
    offs = torch.zeros(2, dtype=torch.int32)
    syms = torch.zeros(256, dtype=torch.uint8)
    table = ((0,) * 16, (0,) * 16)
    with pytest.raises(ValueError, match="offsets"):
        decode_cuda.decode_images(words, offs.long(), syms, *table,
                                  num_frames=1, bh=1, bw=2, delta=True)
    with pytest.raises(ValueError, match="block offsets"):
        decode_cuda.decode_images(words, offs, syms, *table,
                                  num_frames=1, bh=1, bw=3, delta=True)
    with pytest.raises(ValueError, match="delta2d"):
        decode_cuda.decode_images(words, offs, syms, *table, num_frames=1,
                                  bh=1, bw=2, delta=True, delta2d=True)
    for steps in (0, 6, 260):
        with pytest.raises(ValueError, match="multiple of 4"):
            decode_cuda.decode_blocks(words, offs, syms, *table,
                                      num_steps=steps, delta=True)
    with pytest.raises(ValueError, match="8x8"):
        decode_cuda.decode_blocks(words, offs, syms, *table, num_steps=16,
                                  delta=False, delta2d=True)


def test_chip_smoke_without_a_card_prints_no_result(capsys):
    assert chip_smoke.main(["--bogus"]) == 2
    assert "--ab" in capsys.readouterr().err
    for argv in ([], ["--ab", "baseline.cu"]):  # no card here: no numbers
        assert chip_smoke.main(argv) == 1
        out = capsys.readouterr()
        assert out.out == "" and "CUDA is not available" in out.err


def test_build_keeps_the_compiler_output_beside_each_library(monkeypatch,
                                                             tmp_path):
    gxx = shutil.which("g++")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "warn.cpp"
    src.write_text('extern "C" int f() { int unused = 0; return 1; }\n')
    out = _build.hashed_path("libwarn", ("-Wall",), (src,))
    _build.compile_all([([gxx, "-Wall", "-shared", "-fPIC", str(src)], out)])
    assert out.is_file() and "unused" in out.with_suffix(".log").read_text()
    # a kernel library without its log counts as unbuilt (no nvcc here)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    paths = {name: _build.library_path(name) for name in _build.KERNELS}
    for p in paths.values():
        p.touch()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    for name, p in paths.items():
        p.with_suffix(".log").write_text(f"ptxas info : {name}\n")
    assert _build.build() == paths
    assert _build.build_log("decode_blocks") == "ptxas info : decode_blocks\n"
