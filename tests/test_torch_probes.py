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

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

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
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            decode_cuda.stage_code(stream.widths, "cpu"))
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
# form, the chains per thread, the stores; the b1 family is B1's lookup
# body, whose bytes are the interval body's)
S2_COUNTERPART = {"base": "gatheradj", "pruned": "maxw", "lut": "gatheradj",
                  "ilp2": "gatheradj", "xorfold": "gatheradj",
                  "b1": "gatheradj", "b1_esc32": "gatheradj",
                  "b1_refill64": "gatheradj", "b1_row8": "gatheradj",
                  "b1_esc32_row8": "gatheradj", "b1_s1smem": "gatheradj"}


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


# -- the b1 family's table and windows, S1's spans and stores --------------

K1, K2 = decode_cuda.LUT_K1, 16 - decode_cuda.LUT_K1
M64 = (1 << 64) - 1


def _lop3(a, b, c, lut):
    """PTX lop3.b32: bit i of the result is bit (a_i*4 + b_i*2 + c_i) of
    ``lut``, on uint32 arrays."""
    out = np.zeros_like(a)
    for combo in range(8):
        if lut >> combo & 1:
            out |= ((a if combo & 4 else ~a) & (b if combo & 2 else ~b)
                    & (c if combo & 1 else ~c))
    return out


@pytest.mark.parametrize("name", list(TABLES))
def test_esc32_table_decodes_every_window_as_the_lookup_table(name):
    # b1_esc32's step (csrc/ablate_decode.cu::window_esc32) in numpy over all
    # 65,536 windows, against lookup_entries' two-level step and the
    # interval decode
    widths = TABLES[name]
    meta = decode_cuda.canonical_meta(widths)
    ent = ablate_decode.esc32_entries(meta)
    e16 = decode_cuda.lookup_entries(meta).astype(np.uint32)
    assert ent.dtype == np.uint32 and ent.size == e16.size
    win = np.arange(1 << 16, dtype=np.uint32)
    e = ent[win >> K2]
    esc = (e & np.uint32(ablate_decode.ESC32)) != 0
    mask = np.full_like(win, ablate_decode.ESC32 | ((1 << K2) - 1))
    idx = _lop3(e, win, mask, 0x58)  # the kernel's esc32_index
    np.testing.assert_array_equal(
        idx[esc], (e[esc] & np.uint32(0x7FFFFFFF)) | (win[esc] & 31))
    e[esc] = ent[idx[esc]]
    assert not ((e & np.uint32(ablate_decode.ESC32)) != 0).any()
    # the u16 table's step, as decode_common.cuh::decode_window_lut
    f = e16[win >> K2]
    esc16 = (f & decode_cuda.ESCAPE) != 0
    f[esc16] = e16[(1 << K1) + (((f[esc16] ^ decode_cuda.ESCAPE) << K2)
                                | (win[esc16] & ((1 << K2) - 1)))]
    np.testing.assert_array_equal(esc, esc16)
    np.testing.assert_array_equal(e, f)
    w, sym = _interval_decode(widths)
    np.testing.assert_array_equal(e >> 8, w)
    np.testing.assert_array_equal(e & 0xFF, sym)
    if name != "constant":  # complete codes: T1 8 KB, T2 at most 24 KB
        assert 4 * (ent.size - (1 << K1)) <= 24 * 1024
        assert ablate_decode.esc32_table(widths, "cpu").t2_in_smem


def _refill(w, pos):
    """decode_common.cuh::refill on python ints: the 64 bits at ``pos``,
    the word index clamped to ``len(w) - 3``."""
    wi = min(pos >> 5, len(w) - 3)
    s = pos & 31
    return ((((w[wi] << 32) | w[wi + 1]) << s | (w[wi + 2] >> (32 - s)))
            & M64)


def _window_at(w0, w1, w2, s):
    return ((((w0 << 32) | w1) << s) | (w2 >> (32 - s))) & M64


def _loads(w, pos, n):
    """``n`` aligned 8-byte loads at ``pos & ~63``, as the kernel makes
    them, each (word 2q, word 2q+1); the model refuses a load past the
    buffer."""
    q = pos >> 6
    assert 2 * q + 2 * n <= len(w), "an aligned load past the buffer"
    return [(w[2 * (q + i)], w[2 * (q + i) + 1]) for i in range(n)]


def _refill64(w, pos):
    """csrc/ablate_decode.cu::refill64 on python ints."""
    n = len(w)
    if (pos >> 5) > n - 3 - (n & 1):
        return _refill(w, pos)
    (a0, a1), (b0, b1) = _loads(w, pos, 2)
    odd = pos & 32
    return _window_at(a1 if odd else a0, b0 if odd else a1,
                      b1 if odd else b0, pos & 31)


def _row8(w, pos, t):
    """b1_row8's windows on python ints: the 64 bits at ``pos`` and at
    ``pos + t`` (t bits taken by the first 4 symbols, 4..64) from one
    128-bit window, or B1's two refills near the buffer's end."""
    n = len(w)
    if (pos >> 5) > n - 5 - (n & 1):
        return _refill(w, pos), _refill(w, pos + t)
    (a0, a1), (b0, b1), (c0, c1) = _loads(w, pos, 3)
    odd, s = pos & 32, pos & 31
    w2 = b1 if odd else b0
    top = _window_at(a1 if odd else a0, b0 if odd else a1, w2, s)
    low = _window_at(w2, c0 if odd else b1, c1 if odd else c0, s)
    return top, (((top << (t - 1)) << 1) | (low >> (64 - t))) & M64


@pytest.mark.parametrize("n_words", [40, 41])
@pytest.mark.parametrize("variant", ["b1_refill64", "b1_row8"])
def test_wide_refills_equal_the_refill_everywhere(variant, n_words):
    # at every bit phase of every word, past last_word too, an even and an
    # odd buffer: the variant's window(s) are B1's refill's
    rng = np.random.default_rng(n_words)
    w = [int(x) for x in rng.integers(0, 1 << 32, n_words, dtype=np.uint64)]
    for pos in range(32 * n_words + 96):
        if variant == "b1_refill64":
            assert _refill64(w, pos) == _refill(w, pos), pos
            continue
        for t in (4, 17, 33, 48, 63, 64):
            # a fast row's second window never needs B1's clamp
            assert _row8(w, pos, t) == (_refill(w, pos),
                                        _refill(w, pos + t)), (pos, t)


def _offsets(rng, n_blocks, base=0):
    """Ascending u32 bit offsets of ``n_blocks`` blocks of 64..1024 bits
    (64 codes of 1..16 bits) from ``base`` -> (int32 tensor, total bits)."""
    ends = base + np.cumsum(rng.integers(64, 1025, n_blocks))
    offs = np.concatenate([[base], ends[:-1]]).astype(np.int64)
    return (torch.from_numpy(offs.astype(np.uint32).view(np.int32)),
            int(ends[-1]))


@pytest.mark.parametrize("cap", [strips.SPAN_WORDS,
                                 strips.PREFETCH_SPAN_WORDS])
@pytest.mark.parametrize("case", ["random", "past 2^31", "short last CTA",
                                  "one CTA", "photo"])
def test_cta_spans_hold_every_word_a_refill_reads(case, cap, batch):
    rng = np.random.default_rng(len(case))
    if case == "photo":
        _frames, stream, args, _geo = batch
        offsets, total = args[1], 8 * stream.code_bytes.size
        n_words = args[0].numel()
    else:
        n_blocks = {"random": 1024, "past 2^31": 2 * 256 + 5,
                    "short last CTA": 3 * 256 + 37, "one CTA": 100}[case]
        offsets, total = _offsets(rng, n_blocks,
                                  2**31 + 12345 if case == "past 2^31" else 0)
        n_words = (total + 31) // 32 + decode_cuda.PAD_WORDS
    spans = strips.cta_spans(offsets, n_words, cap).numpy()
    off = offsets.numpy().view(np.uint32).astype(np.int64)
    if case == "past 2^31":
        assert off[-1] > 2**31 and (offsets < 0).all()
    ends = np.append(off[1:], total)
    assert spans.shape == (-(-off.size // 256), 2)
    for c, (lo, hi) in enumerate(spans):
        # the bulk copy: 16-byte aligned, a multiple of 16 bytes but at the
        # buffer's end, inside the buffer and the kernel's span buffer
        assert lo % 4 == 0 and (hi % 4 == 0 or hi == n_words)
        assert lo <= hi <= n_words and hi - lo <= cap
        blk = slice(256 * c, 256 * (c + 1))
        # a block's groups start from its offset to 4 bits before its end
        # and read 3 words from there; only a span longer than the buffer
        # (a prefetch buffer's, past 16 KB) leaves its excess to global
        # memory
        assert (off[blk] >> 5 >= lo).all()
        held = ((ends[blk] - 4) >> 5) + 2 < hi
        assert held.all() or (cap < strips.SPAN_WORDS and hi - lo == cap)


@pytest.mark.parametrize("geo", [(2, 3, 256), (1, 20, 240), (1, 1, 1001),
                                 (2, 4, 97), (1, 40, 37), (1, 9, 5),
                                 (3, 2, 6)])
def test_strip_stores_write_every_row_once_aligned(geo):
    # S1's strip and its stores, CUDA block by CUDA block: every block row
    # of the image written once with its own row, every bulk copy 16-byte
    # aligned at both ends and a multiple of 16 bytes
    t, bh, bw = geo
    nb = t * bh * bw
    cells = np.zeros(t * bh * 8 * bw, np.int64)  # 8-byte cells of the image
    runs = 0
    for b0 in range(0, nb, strips.CTA_BLOCKS):
        n = min(strips.CTA_BLOCKS, nb - b0)
        slots, stores = strips.strip_stores(b0, n, bw)
        strip = np.zeros((8, strips.SLOTS), np.int64)
        for dy in range(8):
            for k in range(n):
                assert 0 <= slots[dy][k] < strips.SLOTS
                assert strip[dy, slots[dy][k]] == 0
                strip[dy, slots[dy][k]] = 1 + 8 * (b0 + k) + dy
        for bulk, dy, slot, dst, nbytes in stores:
            assert dst % 8 == 0 and nbytes % 8 == 0
            if bulk:
                assert slot % 2 == 0 and dst % 16 == 0 and nbytes % 16 == 0
                runs += 1
            else:
                assert nbytes == 8
            k = nbytes // 8
            assert slot + k <= strips.SLOTS
            assert (cells[dst // 8: dst // 8 + k] == 0).all()
            cells[dst // 8: dst // 8 + k] = strip[dy, slot: slot + k]
    want = (1 + 8 * np.arange(nb).reshape(t, bh, 1, bw)
            + np.arange(8).reshape(1, 1, 8, 1)).reshape(-1)
    np.testing.assert_array_equal(cells, want)
    if bw % 2 == 0 or bw > 40:
        assert runs  # the geometry has bulk stores


def test_probe_kernel_constants_match_the_wrappers():
    csrc = ROOT / "metalhuffman_tpu_torch" / "csrc"
    ablate = (csrc / "ablate_decode.cu").read_text()
    assert ("kB1 = 5, kEsc32 = 6, kRefill64 = 7, kRow8 = 8, kEsc32Row8 = 9,\n"
            "              kB1S1Smem = 10;" in ablate)
    # b1_s1smem pads by S1's span buffer and strip
    assert ("kS1ExtraBytes = 4 * 8200 + 8 * (256 + 8) * 8;" in ablate
            and strips.SPAN_WORDS == 8200 and strips.SLOTS == 256 + 8)
    assert ablate_decode.VARIANTS[5:] == ablate_decode.B1_FAMILY == (
        "b1", "b1_esc32", "b1_refill64", "b1_row8", "b1_esc32_row8",
        "b1_s1smem")
    assert "lop3.b32 %0, %1, %2, %3, 0x58;" in ablate
    assert "0x80000000u | ((1u << mht::kK2) - 1)" in ablate
    assert ablate_decode.ESC32 == 0x80000000
    strip_src = (csrc / "decode_strips.cu").read_text()
    for const in (f"kSpanWords = {strips.SPAN_WORDS};",
                  f"kPrefetchSpanWords = {strips.PREFETCH_SPAN_WORDS};",
                  "kSlots = kThreads + 8;",
                  f"kMaxRuns = {strips.MAX_RUNS};"):
        assert const in strip_src
    assert strips.SLOTS == strips.CTA_BLOCKS + 8


# -- routing ----------------------------------------------------------------

def _meta_args():
    return (torch.zeros(8, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            decode_cuda.Code(
                torch.zeros(256, dtype=torch.uint8, device="meta"),
                (0,) * 16, (0,) * 16,
                torch.zeros(2048, dtype=torch.int16, device="meta")))


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


def test_b1_family_and_strips_launch_with_their_tables(monkeypatch, batch):
    # CPU tensors routed as CUDA ones and the launch recorded instead of
    # made: each wrapper's CUDA path up to the C call
    calls = []
    real = decode_cuda._check_inputs
    monkeypatch.setattr(decode_cuda, "_check_inputs",
                        lambda *a: "cuda" if real(*a) == "cpu" else "?")
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    _frames, stream, args, geo = batch
    table = args[2]  # the code's lookup table
    table32 = ablate_decode.esc32_table(stream.widths, "cpu")
    before = _counts()
    for v in ablate_decode.ESC32_VARIANTS:
        with pytest.raises(ValueError, match="esc32_table"):
            ablate_decode.ablate_decode(*args, **geo, variant=v)
    assert calls == [] and _counts() == before
    for v in ablate_decode.B1_FAMILY:
        ablate_decode.ablate_decode(*args, **geo, variant=v, table32=table32)
    for prefetch in strips.FORMS.values():
        strips.decode_strips(*args, **geo, prefetch=prefetch)
    assert [name for name, _ in calls] == \
        (["ablate_decode"] * len(ablate_decode.B1_FAMILY)
         + ["decode_strips"] * len(strips.FORMS))
    for name, a in calls:  # every argument but the stream
        assert len(a) + 1 == len(_build._ARGTYPES[name])
    for v, (_, a) in zip(ablate_decode.B1_FAMILY, calls):
        assert a[9] == ablate_decode.VARIANTS.index(v)
        tab = table32 if v in ablate_decode.ESC32_VARIANTS else table
        assert a[-4:-1] == (tab.entries.data_ptr(), tab.entries.numel(), 1)
    for (_, a), prefetch in zip(calls[-2:], (0, 1)):
        assert a[5:9] == (table.entries.data_ptr(), table.entries.numel(), 1,
                          prefetch)
    after = _counts()
    assert after[0]["decode_strips"] == before[0]["decode_strips"] + 2
    assert after[1]["ablate_decode"] == \
        before[1]["ablate_decode"] + len(ablate_decode.B1_FAMILY)
