"""The operands and the prologue of the stem kernel (K4) on the CPU.

``kernel_operands`` lays out the folded weights, the biases and the BN
affine as ``csrc/fused_stem_bottleneck.cu`` reads them. The kernel runs
only on the card; here the weight image is unpacked by the plain inverse
of ``tests/test_torch_port_operands.py`` (written from the layout's
description, not from the packing code), bit for bit, and the plain
version on the unpacked operands must equal the plain version on the
originals.

The kernel's prologue is mirrored in Python, index for index: the raw strip
boxes as TMA lays them out (origin, NaN fill outside x and beyond C,
128-byte swizzle), the pool of each warp's units (the bf16 affine, the max
from 0 that drops NaN as max.bf16x2 does), the swizzled pooled halo it
writes, and the ldmatrix addresses of the projection's A. The mirror must
give ``F.max_pool2d`` of the affine-ReLU'd map at every halo pixel inside
the map, over ragged tiles and the map's border.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dir_tpu_torch.ops import fused_stem_bottleneck as st

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_operands import _unpack  # noqa: E402

BF = torch.bfloat16
# (C, mid, O): the stem's widths and the two narrow ones of the card tests
WIDTHS = [(64, 64, 256), (16, 16, 32), (32, 32, 48)]

# csrc/fused_stem_bottleneck.cu's tiling
TH, TW = 8, 16
HALO_W = TW + 2
HALO, HALO_ROWS = (TH + 2) * HALO_W, 192
STRIPS, STRIP_W, STRIP_H = 5, 2 * HALO_W + 1, 5
ROUNDS = 9                           # warp rounds of a strip's 288 units


def _inputs(seed, c, mid, o):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(
            (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1])))
            .astype(np.float32))

    def b(n):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32))

    g1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    t1 = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    return g1, t1, [t(c, mid), b(mid), t(3, 3, mid, mid), b(mid), t(mid, o),
                    b(o), t(c, o), b(o)]


def _bits(t):
    return t.to(BF).view(torch.int16).numpy()


@pytest.mark.parametrize("c,mid,o", WIDTHS)
def test_stem_operands_unpack_to_the_bf16_weights(c, mid, o):
    g1, t1, ws = _inputs(1, c, mid, o)
    op = st.kernel_operands(g1, t1, *ws)
    assert (op.c, op.mid, op.o) == (c, mid, o)
    assert op.image.dtype == BF and op.image.numel() * 2 == st.layout(
        c, mid, o).image_bytes
    w1, w2, w3, wd, pads = _unpack(op.image.view(torch.int16).numpy(), c,
                                   mid, o, True)
    for got, want in zip((w1, w2, w3, wd), ws[0::2]):
        np.testing.assert_array_equal(got, _bits(want))
    for p in pads:
        assert not p.any()
    # the biases: b1, b2, then b3 and bd each zero-padded to whole chunks
    n3 = max(32, mid)
    opad = -(-o // n3) * n3
    assert op.vec.dtype == torch.float32 and op.vec.numel() == 2 * mid + 2 * opad
    b1, b2, b3, bd = torch.split(op.vec, [mid, mid, opad, opad])
    for got, want in zip((b1, b2, b3[:o], bd[:o]), ws[1::2]):
        assert torch.equal(got, want)
    assert not b3[o:].any() and not bd[o:].any()
    # g1 and t1 as the plain version casts them, zero beyond C
    assert op.gt.dtype == BF and op.gt.shape == (2, 64)
    assert torch.equal(op.gt[0, :c], g1.to(BF))
    assert torch.equal(op.gt[1, :c], t1.to(BF))
    assert not op.gt[:, c:].float().any()


@pytest.mark.parametrize("c,mid,o", WIDTHS)
def test_stem_plain_on_unpacked_operands_is_the_plain_version(c, mid, o):
    g1, t1, ws = _inputs(2, c, mid, o)
    op = st.kernel_operands(g1, t1, *ws)
    w1, w2, w3, wd, _ = _unpack(op.image.view(torch.int16).numpy(), c, mid,
                                o, True)

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).view(BF)

    n3 = max(32, mid)
    opad = -(-o // n3) * n3
    b1, b2, b3, bd = torch.split(op.vec, [mid, mid, opad, opad])
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 16, 24, c).astype(np.float32)).to(BF)
    want = st.fused_stem_bottleneck_plain(x, g1, t1, *ws)
    got = st.fused_stem_bottleneck_plain(
        x, op.gt[0, :c], op.gt[1, :c], bf(w1), b1, bf(w2), b2, bf(w3),
        b3[:o], bf(wd), bd[:o])
    assert torch.equal(got, want)


def test_stem_layout_budget():
    """The stem's widths fit two strip stages beside the resident weights
    (the header's budget: 144 KB of weights, 27 KB of pooled halo / y1);
    narrower widths take four; the kernel takes C up to 64 and mid up to 64."""
    assert st.layout(64, 64, 256) == st.Layout(147456, 229120, 2)
    assert st.layout(16, 16, 32).stages == 4
    assert st.layout(32, 32, 48).stages == 4
    g1, t1, ws = _inputs(4, 128, 64, 256)
    with pytest.raises(ValueError):      # C beyond one 64-channel panel
        st.kernel_operands(g1, t1, *ws)
    g1, t1, ws = _inputs(4, 64, 128, 256)
    with pytest.raises(ValueError):      # w2 at mid 128 does not fit
        st.kernel_operands(g1, t1, *ws)
    g1, t1, ws = _inputs(4, 64, 64, 256)
    with pytest.raises(ValueError):      # g1 of another width
        st.kernel_operands(g1[:32], t1, *ws)


# --- the prologue, index for index ----------------------------------------

def _swizzled(row, chunk):
    """Index of the 16-byte chunk ``chunk`` of 128-byte row ``row`` in
    128-byte-swizzled rows, in units of 16 bytes."""
    return row * 8 + (chunk ^ (row & 7))


def _strip_box(xb, n, ry0, rx0):
    """The strip as TMA lays it out in shared memory: 37 x 5 raw pixels of
    64 channels from (ry0, rx0), NaN outside x and beyond C (the map's
    fill), as 16-byte chunks (185 * 8, 8), swizzled."""
    _, h2, w2, c = xb.shape
    box = torch.full((STRIP_H, STRIP_W, 64), float("nan"), dtype=BF)
    ys, xs = ry0 + np.arange(STRIP_H), rx0 + np.arange(STRIP_W)
    vy = np.flatnonzero((ys >= 0) & (ys < h2))
    vx = np.flatnonzero((xs >= 0) & (xs < w2))
    if vy.size and vx.size:
        box[vy[:, None], vx[None, :], :c] = xb[n][ys[vy][:, None],
                                                  xs[vx][None, :]]
    chunks = box.reshape(STRIP_H * STRIP_W, 8, 8)
    smem = torch.empty(STRIP_H * STRIP_W * 8, 8, dtype=BF)
    pix = np.arange(STRIP_H * STRIP_W)[:, None]
    ch = np.arange(8)[None, :]
    smem[_swizzled(pix, ch)] = chunks[pix, ch]
    return smem


def _units(s):
    """(warp, lane, round) of every unit of strip s: warp w takes rounds
    (w - s) mod 8 and, when that is 0, round 8."""
    out = [(w, lane, q) for w in range(8)
           for q in range((w - s) & 7, ROUNDS, 8) for lane in range(32)]
    return [np.array(a) for a in zip(*out)]


def _pool_tile(xb, gk, tk, n, ty0, tx0):
    """The consumers' pool of one tile: the pooled halo (192 * 8, 8) as they
    write it, and the halo rows each strip wrote."""
    halo = torch.full((HALO_ROWS * 8, 8), float("nan"), dtype=BF)
    halo[HALO * 8:] = 0                       # rows 180-191
    rows_of = []
    for s in range(STRIPS):
        ry0, rx0 = 2 * ty0 - 3 + 4 * s, 2 * tx0 - 3
        smem = _strip_box(xb, n, ry0, rx0)
        _, lane, q = _units(s)
        pp = 4 * q + (lane >> 3)
        pr, pc, k = pp // HALO_W, pp % HALO_W, lane & 7
        r0 = 2 * pr * STRIP_W + 2 * pc
        best = torch.zeros(len(lane), 8, dtype=BF)
        for dy in range(3):
            for dx in range(3):
                raw = smem[_swizzled(r0 + dy * STRIP_W + dx, k)]
                a = raw * gk[k] + tk[k]      # each op rounded to bf16
                best = torch.fmax(best, a)   # NaN gives the other operand
        hp = (2 * s + pr) * HALO_W + pc
        at = _swizzled(hp, k)
        assert len(set(at.tolist())) == len(at) == 2 * HALO_W * 8
        halo[at] = best
        rows_of.append(sorted(set((hp // HALO_W).tolist())))
    return halo, rows_of


def _unswizzle(halo):
    r = np.arange(HALO_ROWS)[:, None]
    c = np.arange(8)[None, :]
    return halo[_swizzled(r, c)].reshape(HALO_ROWS, 64)


def _ldmatrix_fragments(halo, oy):
    """The projection's A registers of each lane of the warp that owns
    output row oy: (32, 4 kk, 4 registers, 2 values)."""
    lanes = np.arange(32)
    arow = (lanes & 7) + ((lanes >> 3) & 1) * 8
    out = torch.empty(32, 4, 4, 2, dtype=BF)
    for kk in range(4):
        # the 16 bytes each lane's address points at: row (lane % 8) of
        # matrix lane / 8
        rows = halo[_swizzled((oy + 1) * HALO_W + 1 + arow,
                              2 * kk + (lanes >> 4))]
        for t in range(32):
            for i in range(4):
                out[t, kk, i] = rows[8 * i + t // 4, 2 * (t % 4):2 * (t % 4) + 2]
    return out


@pytest.mark.parametrize("c,t_low", [(64, 0.2), (32, -0.5), (16, 0.2)])
def test_stem_prologue_mirror_is_the_max_pool(c, t_low):
    """Every tile of a map with ragged tiles on both axes (pooled 20 x 36:
    tiles of 8 x 16 leave 4 rows and 4 columns): the pooled halo equals
    max_pool2d of relu(x * g1 + t1) at every pixel inside the map, rows
    180-191 are zero, strip s makes halo rows 2s and 2s + 1, and the
    projection's ldmatrix fragments are the tile's own pixels in the mma A
    layout. With t1 > 0 on every channel and x mostly below -t1 / g1, a
    zero-filled raw pixel taken into the pool would show at the border;
    the NaN fill drops out of the max."""
    rng = np.random.RandomState(5)
    b, h, w = 2, 20, 36
    xb = torch.from_numpy((rng.randn(b, 2 * h, 2 * w, c) - 1.0)
                          .astype(np.float32)).to(BF)
    g1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    t1 = torch.from_numpy(rng.uniform(t_low, 0.6, c).astype(np.float32))
    gt = F.pad(torch.stack([g1, t1]).to(BF), (0, 64 - c))
    gk, tk = gt[0].reshape(8, 8), gt[1].reshape(8, 8)
    a = torch.relu(xb * g1.to(BF) + t1.to(BF))
    pooled = F.max_pool2d(a.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    assert pooled.shape == (b, h, w, c)
    nty, ntx = -(-h // TH), -(-w // TW)
    border_differs = 0
    for n in range(b):
        for ty in range(nty):
            for tx in range(ntx):
                ty0, tx0 = ty * TH, tx * TW
                halo, rows_of = _pool_tile(xb, gk, tk, n, ty0, tx0)
                assert rows_of == [[2 * s, 2 * s + 1] for s in range(STRIPS)]
                vals = _unswizzle(halo)
                assert not vals[HALO:].float().any()
                r = np.arange(HALO)
                gy, gx = ty0 - 1 + r // HALO_W, tx0 - 1 + r % HALO_W
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                want = pooled[n, gy[inside], gx[inside]]
                assert torch.equal(vals[r[inside], :c], want)
                assert not vals[:HALO, c:].float().any()
                # the same windows with a zero fill taken in (the fault the
                # NaN fill prevents) differ on the map's border here
                leak = torch.maximum(want, torch.relu(t1.to(BF)))
                edge = ((gy[inside] == 0) | (gx[inside] == 0))
                border_differs += int((leak[edge] != want[edge]).any())
                for oy in range(TH):
                    frag = _ldmatrix_fragments(halo, oy)
                    tile = vals[(oy + 1) * HALO_W + 1 + np.arange(16)]
                    for t in range(32):
                        g4, tig = t // 4, t % 4
                        for kk in range(4):
                            k0 = 16 * kk + 2 * tig
                            want_regs = [tile[g4, k0:k0 + 2],
                                         tile[g4 + 8, k0:k0 + 2],
                                         tile[g4, k0 + 8:k0 + 10],
                                         tile[g4 + 8, k0 + 8:k0 + 10]]
                            for i in range(4):
                                assert torch.equal(frag[t, kk, i],
                                                   want_regs[i])
    if t_low > 0:
        assert border_differs > 0


def test_stem_strip_units_cover_each_strip_once():
    """Each strip's 288 units (36 pooled pixels x 8 channel chunks) are
    made exactly once, every warp has a round in every strip (it releases
    each strip once), and the ninth round rotates over the warps."""
    extra = []
    for s in range(STRIPS):
        wid, lane, q = _units(s)
        pp = 4 * q + (lane >> 3)
        pairs = set(zip(pp.tolist(), (lane & 7).tolist()))
        assert len(pairs) == len(q) == 288
        assert set(wid.tolist()) == set(range(8))
        counts = np.bincount(wid, minlength=8) // 32
        extra.append(int(np.argmax(counts)))
        assert sorted(counts.tolist()) == [1] * 7 + [2]
    assert extra == [s % 8 for s in range(STRIPS)]
