"""Parity of the port's probes of B1 (metalhuffman_tpu_torch.probes: S1
strips, S2 decode variants, S3 integer rate) with the JAX scratch kernels
they port, run in Pallas interpret mode on the CPU; the port's copy of the
split lookup tables against the original; and the probes' routing.

The scratch kernels are reached through their own bodies
(``ablate_decode.build_variant``; ``kernel_strips.make_kernel`` and
``int16_rate.make_kernel`` in a ``pallas_call`` built here with
``interpret=True``), at the size ``ablate_decode.main`` shrinks to on the
CPU (3x64x1024). Every comparison is exact: tolerance 0.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.core import tables as jtables
from metalhuffman_tpu.models import CodecConfig, frame_stream
from metalhuffman_tpu.ops import decode_pallas as dp
from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.core import tables
from metalhuffman_tpu_torch.ops import decode_cuda
from metalhuffman_tpu_torch.probes import ablate_decode, int16_rate, strips
from metalhuffman_tpu_torch.utils import fixtures

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # the scratch scripts import bench

import bench  # noqa: E402


def _scratch(name):
    """A scratch script as a module of its own name (scratch/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"scratch_{name}", ROOT / "scratch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


T, H, W = 3, 64, 1024  # ablate_decode.main's CPU size (one 128-lane h2 group)


@pytest.fixture(scope="module")
def batch():
    """The photo batch, its stream (JAX package encoder) and the port's
    staging of it on the CPU."""
    frames = bench.photo_frames(H, W, T)
    stream = frame_stream.encode_frames_shared(
        frames, CodecConfig(backend="pallas"))
    meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            torch.from_numpy(meta.symbols), meta.bounds, meta.adj)
    geo = dict(num_frames=T, bh=H // 8, bw=W // 8)
    return frames, stream, args, geo


def _strips_image(strips_out):
    """(ng, rows_pp, 8, W//4) int32 strips -> (T, H, W) uint8."""
    img32 = np.asarray(dp.images_from_strips(strips_out, T, H, W))
    return img32.view(np.uint8).reshape(T, H, W)


@pytest.fixture(scope="module")
def jax_s2(batch):
    """S2's Pallas variants in interpret mode -> {TPU variant: image}:
    ``gatheradj`` (B1's body, the port's ``base``) and ``maxw`` (pruned
    compares with the fused accumulator, the port's ``pruned``)."""
    s2 = _scratch("ablate_decode")
    _frames, stream, _args, _geo = batch
    meta, words, offsets, wpr = dp.prepare_stream(stream)
    plan = dp.image_plan_for(H, W, 8)
    offs = dp.pad_offsets_grid(jnp.asarray(offsets), T * plan.bh, plan.bw,
                               plan.bw_pad)
    rows, init, _ = dp.tile_layout_images(jnp.asarray(words), offs, wpr,
                                          plan.h2, group_tiles=8)
    return {v: _strips_image(s2.build_variant(v, [(rows, init)], meta, wpr,
                                              plan.h2)[1])
            for v in ("gatheradj", "maxw")}


@pytest.fixture(scope="module")
def jax_s1(batch):
    """S1's Pallas kernel in interpret mode -> image, staged as
    ``kernel_strips.main`` stages it (one 128-lane group per block row here,
    so its h-major feed permutation is the identity)."""
    s1 = _scratch("kernel_strips")
    _frames, stream, _args, _geo = batch
    meta, words, offsets, width = dp.prepare_stream(stream)
    g, h2 = 3, 1
    sub = 8 * g
    rows, init, _ = dp.tile_layout_jax(jnp.asarray(words),
                                       jnp.asarray(offsets), width,
                                       group_tiles=g)
    ng = rows.shape[0] // g
    rows_g = rows.reshape(ng, g, width, 8, 128).transpose(
        0, 2, 1, 3, 4).reshape(ng, width, sub, 128)
    init_g = init.reshape(ng, sub, 128)
    pair_g = jnp.tile(jnp.asarray(meta.pair_table), (g, 1))
    out = pl.pallas_call(
        s1.make_kernel(width, meta.bounds, meta.adj_inc, sub, h2),
        grid=(ng,),
        in_specs=[pl.BlockSpec((1, width, sub, 128), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, sub, 128), lambda i: (i, 0, 0)),
                  pl.BlockSpec((sub, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, sub // h2, 8, h2 * 256),
                               lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((ng, sub // h2, 8, h2 * 256),
                                       jnp.int32),
        interpret=True,
    )(rows_g, init_g, pair_g)
    return _strips_image(out)


def test_strips_plain_matches_pallas(batch, jax_s1):
    frames, _stream, args, geo = batch
    np.testing.assert_array_equal(jax_s1, frames)
    plain = strips.decode_strips_plain(*args, **geo)
    np.testing.assert_array_equal(plain.numpy(), jax_s1)
    before = dict(strips.launches)
    assert torch.equal(strips.decode_strips(*args, **geo), plain)
    assert strips.launches == before


# the port's variant -> the TPU variant that computes its bytes the same way
# (lut, ilp2 and xorfold change what every TPU variant shares: the table
# form, the chains per thread, the stores)
S2_COUNTERPART = {"base": "gatheradj", "pruned": "maxw", "lut": "gatheradj",
                  "ilp2": "gatheradj", "xorfold": "gatheradj"}


@pytest.mark.parametrize("variant", ablate_decode.VARIANTS)
def test_ablate_decode_plain_matches_pallas(batch, jax_s2, variant):
    frames, stream, args, geo = batch
    ref = jax_s2[S2_COUNTERPART[variant]]
    np.testing.assert_array_equal(ref, frames)
    plain = ablate_decode.ablate_decode_plain(*args, **geo, variant=variant)
    if variant == "xorfold":
        ref = ablate_decode.xor_fold(torch.from_numpy(ref.copy()), **geo)
        assert plain.shape == (T * H * W // 64,) and plain.dtype == torch.int64
        assert torch.equal(plain, ref)
    else:
        np.testing.assert_array_equal(plain.numpy(), ref)
    before = dict(ablate_decode.launches)
    lut = ablate_decode.lut_tables(stream.widths, "cpu")
    assert torch.equal(ablate_decode.ablate_decode(
        *args, **geo, variant=variant, lut=lut), plain)
    assert ablate_decode.launches == before


# S3: the port's variant -> the TPU probe's tile of the same element type
S3_COUNTERPART = {"i32": (jnp.int32, (8, 128)), "i16": (jnp.int16, (8, 128)),
                  "i16x2": (jnp.int16, (16, 128))}


@pytest.mark.parametrize("variant", int16_rate.VARIANTS)
def test_int16_rate_plain_matches_pallas(variant):
    s3 = _scratch("int16_rate")
    dtype, shape = S3_COUNTERPART[variant]
    x = np.random.default_rng(0).integers(0, 100, (2,) + shape)  # 2 tiles
    ref = pl.pallas_call(
        s3.make_kernel(dtype), grid=(2,),
        in_specs=[pl.BlockSpec((1,) + shape, lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1,) + shape, lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((2,) + shape, dtype),
        interpret=True,
    )(jnp.asarray(x, dtype))
    xt = torch.from_numpy(x.reshape(-1)).to(int16_rate.dtype_of(variant))
    plain = int16_rate.int16_rate_plain(xt, variant)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref).reshape(-1))
    before = dict(int16_rate.launches)
    assert torch.equal(int16_rate.int16_rate(xt, variant), plain)
    assert int16_rate.launches == before


def test_int16_rate_plain_wraps_like_its_type():
    for variant, top in (("i32", 2**31 - 1), ("i16", 2**15 - 1)):
        x = torch.tensor([top - 100, -5], dtype=int16_rate.dtype_of(variant))
        got = int16_rate.int16_rate_plain(x, variant).tolist()
        bits = 32 if variant == "i32" else 16
        want = []
        for v0 in (top - 100, -5):
            v, acc = v0, 0
            for _ in range(int16_rate.CHAIN):
                v = (v + 1 + 2 ** (bits - 1)) % 2 ** bits - 2 ** (bits - 1)
                acc += v > 7
            want.append((v + acc + 2 ** (bits - 1)) % 2 ** bits
                        - 2 ** (bits - 1))
        assert got == want


# -- the port's copy of the split lookup tables ---------------------------

def _encoder_sets():
    """The five sets of tests/test_encode_pallas.py, same seed and order."""
    rng = np.random.default_rng(7)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    p = 0.8 ** np.arange(32)
    yield "skewed", rng.choice(np.arange(32), size=64 * 300 + 17,
                               p=p / p.sum()).astype(np.uint8)
    yield "constant", np.full(64 * 10 + 5, 9, np.uint8)
    yield "two-sym", rng.choice([7, 200], size=64 * 130,
                                p=[0.93, 0.07]).astype(np.uint8)
    adv = np.concatenate([np.full(2 ** i, i, np.uint8) for i in range(24)])
    rng.shuffle(adv)
    yield "longcodes", adv[: adv.size // 64 * 64]


def _table_widths():
    """name -> widths: the encoder tests' tables, the photo's, and one of 128
    secondary tables (254 9-bit codes)."""
    out = {name: jnative.code_lengths(np.bincount(d, minlength=256))
           for name, d in _encoder_sets()}
    out["photo"] = frame_stream.encode_frames_shared(
        fixtures.photo()[None], CodecConfig()).widths
    wide = np.full(256, 9, np.uint8)
    wide[0], wide[1] = 1, 8
    out["128-t2"] = wide
    return out


TABLES = _table_widths()


@pytest.mark.parametrize("name", list(TABLES))
def test_split_tables_match_original(name):
    widths = TABLES[name]
    ours = tables.build_split_tables(widths)
    ref = jtables.build_split_tables(widths)
    for field in ("t1_symbol", "t1_width", "t2_symbol", "t2_width"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tables.K1, tables.K2, ours.num_t2_tables) == (
        ref.k1, ref.k2, ref.num_t2_tables)
    packed = tables.pack_entries(ours.t2_symbol, ours.t2_width)
    np.testing.assert_array_equal(
        packed, jtables.pack_entries(ref.t2_symbol, ref.t2_width))
    for a, b in zip(tables.unpack_entry(packed), jtables.unpack_entry(packed)):
        np.testing.assert_array_equal(a, b)
    if name == "longcodes":
        assert widths.max() == 16
    if name == "128-t2":
        assert ours.num_t2_tables == 128


def _interval_decode(widths):
    """(width, symbol) of every 16-bit window by the interval table the
    decode kernels use."""
    meta = decode_cuda.canonical_meta(widths)
    win = np.arange(1 << 16)
    w = 1 + (win[:, None] >= np.asarray(meta.bounds[1:])[None]).sum(1)
    idx = np.asarray(meta.adj)[w - 1] + (win >> (16 - w))
    return w, meta.symbols[idx & 255]


@pytest.mark.parametrize("name", [n for n in TABLES if n != "constant"])
def test_lut_tables_decode_every_window_as_the_interval_table(name):
    # the lut variant's two-level lookup, done in numpy over all windows
    widths = TABLES[name]
    lut = ablate_decode.lut_tables(widths, "cpu")
    t1 = lut.t1.numpy().view(np.uint16).astype(np.int64)
    t2 = lut.t2.numpy().view(np.uint16).astype(np.int64)
    win = np.arange(1 << 16)
    e = t1[win >> 8]
    esc = (e >> 8) == 0
    e[esc] = t2[((e[esc] & 0xFF) << 8) | (win[esc] & 0xFF)]
    w, sym = _interval_decode(widths)
    np.testing.assert_array_equal(e >> 8, w)
    np.testing.assert_array_equal(e & 0xFF, sym)


@pytest.mark.parametrize("name", list(TABLES))
def test_pruned_terms_give_the_interval_width_and_adj(name):
    widths = TABLES[name]
    meta = decode_cuda.canonical_meta(widths)
    t_bounds, t_incs, base = ablate_decode.pruned_terms(meta.bounds, meta.adj)
    assert len(t_bounds) <= ablate_decode.MAX_TERMS
    assert list(t_bounds) == sorted(set(t_bounds))
    win = np.arange(1 << 16)
    acc = base + ((win[:, None] >= np.asarray(t_bounds, np.int64)[None])
                  * np.asarray(t_incs, np.int64)[None]).sum(1)
    w = 1 + (win[:, None] >= np.asarray(meta.bounds[1:])[None]).sum(1)
    np.testing.assert_array_equal(acc & 0xFF, w)
    np.testing.assert_array_equal((acc >> 8) - (1 << 16),
                                  np.asarray(meta.adj)[w - 1])
    assert (acc > 0).all() and (acc < 2**31).all()  # the kernel's int32


# -- routing ----------------------------------------------------------------

def _meta_args():
    return (torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.zeros(256, dtype=torch.uint8, device="meta"),
            (0,) * 16, (0,) * 16)


def _counts():
    return (dict(strips.launches), dict(ablate_decode.launches),
            dict(int16_rate.launches))


def test_probes_off_cpu_raise_instead_of_plain():
    before = _counts()
    geo = dict(num_frames=1, bh=1, bw=2)
    with pytest.raises(ValueError, match="meta"):
        strips.decode_strips(*_meta_args(), **geo)
    for v in ablate_decode.VARIANTS:
        with pytest.raises(ValueError, match="meta"):
            ablate_decode.ablate_decode(*_meta_args(), **geo, variant=v)
    for v in int16_rate.VARIANTS:
        x = torch.zeros(4, dtype=int16_rate.dtype_of(v), device="meta")
        with pytest.raises(ValueError, match="meta"):
            int16_rate.int16_rate(x, v)
    assert _counts() == before


def test_probes_on_cpu_never_reach_the_build(monkeypatch, batch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached _build")

    for name in ("launch", "build", "lib"):
        monkeypatch.setattr(_build, name, refuse)
    _frames, stream, args, geo = batch
    before = _counts()
    strips.decode_strips(*args, **geo)
    lut = ablate_decode.lut_tables(stream.widths, "cpu")
    for v in ablate_decode.VARIANTS:
        ablate_decode.ablate_decode(*args, **geo, variant=v, lut=lut)
    for v in int16_rate.VARIANTS:
        int16_rate.int16_rate(int16_rate.make_input(64, v, "cpu"), v)
    assert _counts() == before


def test_probes_check_their_inputs(batch):
    _frames, _stream, args, geo = batch
    with pytest.raises(ValueError, match="variant"):
        ablate_decode.ablate_decode(*args, **geo, variant="stride2")
    with pytest.raises(ValueError, match="variant"):
        ablate_decode.ablate_decode_plain(*args, **geo, variant="maxw")
    with pytest.raises(ValueError, match="block offsets"):
        strips.decode_strips(*args, num_frames=T, bh=H // 8, bw=W // 8 + 1)
    with pytest.raises(ValueError, match="int16"):
        int16_rate.int16_rate(torch.zeros(4, dtype=torch.int32), "i16")
    with pytest.raises(ValueError, match="even"):
        int16_rate.int16_rate(torch.zeros(3, dtype=torch.int16), "i16x2")
    with pytest.raises(ValueError, match="variant"):
        int16_rate.make_input(4, "i8", "cpu")
