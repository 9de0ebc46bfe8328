"""Guards of the port's boundaries: no JAX, no module-level Triton, a CUDA
build that fails loudly, and no plain-version fallback off the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.ops import decode_cuda

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

PORT_FILES = sorted((ROOT / "metalhuffman_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_and_decodes_without_jax():
    code = """
import sys
sys.modules['jax'] = None  # any import of jax now raises ImportError
import zlib
import numpy as np
import metalhuffman_tpu_torch
from metalhuffman_tpu_torch.ops import decode_cuda
from metalhuffman_tpu_torch.models import frame_stream
frames = np.random.default_rng(0).integers(0, 256, (2, 16, 24), dtype=np.uint8)
stream = frame_stream.encode_frames_shared(frames)
blob = frame_stream.write_shared(stream, 2, 16, 24,
                                 source_crc32=zlib.crc32(frames.tobytes()))
out = metalhuffman_tpu_torch.decode_video(blob, "cpu")
assert (out == frames).all()
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
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
        r"^\s*(import|from)\s+metalhuffman_tpu\.(ops|models|parallel)\b",
        src, re.M)


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
    assert _build.library_path().parent == _build.BUILD_DIR
    assert all(src.suffix == ".cu" and src.is_file() for src in _build.SOURCES)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_decode_images_off_cpu_raises_instead_of_plain():
    args = (torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(256, dtype=torch.uint8, device="meta"),
            (0,) * 16, (0,) * 16)
    before = decode_cuda.launches
    with pytest.raises(ValueError, match="meta"):
        decode_cuda.decode_images(*args, num_frames=1, bh=1, bw=2, delta=True)
    assert decode_cuda.launches == before


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
