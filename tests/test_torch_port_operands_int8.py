"""The operands of the int8 fused-bottleneck kernel (K3) on the CPU.

``kernel_operands`` quantizes the folded weights and lays them out as the
CUDA kernel reads them: one int8 image of (N, K) K-major matrices in
128-byte swizzled panels, K zero-padded, the K of w3 permuted so that the
accumulators a thread holds are its s8 k32 fragment of conv3, the N of w3
and wd in the bf16 kernels' channel order. The kernel runs only on the card;
here a plain inverse, written from the layout's description and from a
simulation of the lane layouts, not from the packing code, unpacks the
image and must give back the quantized weights bit for bit with zeros
everywhere the layout pads, and the plain int8 block on the unpacked
operands must equal the plain version.
"""

import numpy as np
import pytest
import torch

from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops.quant import int_matmul, conv_s32

# (C, mid, O, projection): mid 32/64/128, C and O not multiples of 128,
# conv3 chunks sharing a panel, both residual forms, both kernel forms
CASES = [
    (32, 32, 32, False),
    (64, 32, 96, True),
    (160, 64, 160, False),
    (96, 64, 192, True),
    (256, 64, 256, False),        # the layer1 shape
    (256, 64, 256, True),
    (512, 128, 512, False),       # the layer2 shape
    (384, 128, 256, True),
]


def _weights(seed, c, mid, o, down):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    ws = [t(c, mid), t(mid), t(3, 3, mid, mid), t(mid), t(mid, o), t(o)]
    ws += [t(c, o), t(o)] if down else [None, None]
    scales = [torch.tensor(s) for s in (0.031, 0.017, 0.023)]
    return ws, scales


# ------------------------------------------------------ the lane layouts


def _accumulator_channels(lane):
    """Columns of a 32-column group a thread holds of row g in a wgmma s32
    accumulator (d[4 jn + e] is column 8 jn + 2 t + e), in the order the
    kernel packs them into a0 (jn 0, 1) and a2 (jn 2, 3)."""
    t = lane % 4
    return [8 * jn + 2 * t + e for jn in range(4) for e in range(2)]


def _s8_fragment_positions(lane):
    """K positions of a 32-wide step a thread's s8 A registers a0 and a2
    hold for row g, byte by byte: a0 bytes 4t..4t+3, a2 bytes 16+4t..."""
    t = lane % 4
    return [4 * t + i for i in range(4)] + [16 + 4 * t + i for i in range(4)]


def _simulated_order():
    """The channel each K position must hold, from the lane layouts."""
    order = [None] * 32
    for lane in range(32):
        chans = _accumulator_channels(lane)
        for pos, ch in zip(_s8_fragment_positions(lane), chans):
            assert order[pos] in (None, ch)
            order[pos] = ch
    assert sorted(order) == list(range(32))
    return np.array(order)


def test_k_order_maps_the_fragments_onto_the_s8_positions():
    want = _simulated_order()
    got = q8.k_order(96).numpy()
    for g in range(3):
        np.testing.assert_array_equal(got[32 * g:32 * g + 32], 32 * g + want)


# ------------------------------------------------------- the plain inverse


def _unswizzle(panel: np.ndarray) -> np.ndarray:
    """(R, 128) bytes as stored -> as meant: the 16-byte chunk c of row r
    sits at chunk c ^ (r % 8)."""
    out = np.empty_like(panel)
    for row in range(panel.shape[0]):
        for c in range(8):
            s = c ^ (row % 8)
            out[row, 16 * c:16 * c + 16] = panel[row, 16 * s:16 * s + 16]
    return out


def _take(image, at, rows, k):
    """The (rows, K) matrix whose K (padded to 128) starts at byte ``at``
    in 128-wide panels; returns it unpadded and the padding, and the next
    offset."""
    n_panels = -(-k // 128)
    size = rows * 128
    m = np.concatenate([_unswizzle(image[at + i * size:at + (i + 1) * size]
                                   .reshape(rows, 128))
                        for i in range(n_panels)], axis=1)
    return m[:, :k], m[:, k:], at + n_panels * size


def _unpack(image, c, mid, o, down):
    """The plain inverse of the layout: w1q, w2q, w3q, wdq (K, N as the
    folded weights) and every byte that must be zero."""
    perm = np.concatenate([32 * g + _simulated_order()
                           for g in range(mid // 32)])
    nj = -(-o // mid)
    op = nj * mid
    col = np.arange(op)                       # channel_order, by its rule
    q, r = col // 32, col % 32
    chan = 32 * q + 8 * ((r % 8) // 2) + 2 * (r // 8) + r % 2
    pads = []
    w1t, pad, at = _take(image, 0, mid, c)    # (mid, C)
    pads.append(pad)
    w1 = w1t.T
    w2cat, pad, at = _take(image, at, mid, 9 * mid)
    pads.append(pad)
    w2 = np.stack([w2cat[:, t * mid:(t + 1) * mid].T for t in range(9)])
    w3cat, pad, at = _take(image, at, mid, nj * mid)
    pads.append(pad)

    def unorder(rows_by_col, k):              # (Op, K) -> (K, O)
        full = np.zeros((op, k), np.int8)
        full[chan] = rows_by_col
        pads.append(full[o:])
        return full[:o].T

    w3 = np.empty((mid, o), np.int8)          # its K permuted
    w3[perm] = unorder(np.concatenate([w3cat[:, j * mid:(j + 1) * mid]
                                       for j in range(nj)]), mid)
    wd = None
    if down:
        blocks = []
        for _ in range(nj):
            blk, pad, at = _take(image, at, mid, c)
            pads.append(pad)
            blocks.append(blk)
        wd = unorder(np.concatenate(blocks), c)
    assert at == image.size, "image longer than its layout"
    return w1, w2.reshape(3, 3, mid, mid), w3, wd, pads


@pytest.mark.parametrize("c,mid,o,down", CASES)
def test_int8_operands_unpack_to_the_quantized_weights(c, mid, o, down):
    ws, scales = _weights(1, c, mid, o, down)
    op = q8.kernel_operands(*ws[:6], *scales, ws[6], ws[7])
    assert op.image.dtype == torch.int8
    assert (op.c, op.mid, op.o) == (c, mid, o)
    assert op.image.numel() == q8.layout(c, mid, o, down).image_bytes
    w1, w2, w3, wd, pads = _unpack(op.image.numpy(), c, mid, o, down)
    w1q, w2q, w3q, wdq, inv, m1, m2, m3, md = q8._quantized_operands(
        ws[0], ws[2], ws[4], ws[6], *scales)
    np.testing.assert_array_equal(w1, w1q.numpy())
    np.testing.assert_array_equal(w2, w2q.reshape(3, 3, mid, mid).numpy())
    np.testing.assert_array_equal(w3, w3q.numpy())
    if down:
        np.testing.assert_array_equal(wd, wdq.numpy())
    for p in pads:
        assert not p.any()
    want = [inv, m1, ws[1], m2, ws[3], m3, ws[5], md, ws[7]]
    got = [op.inv, op.m1, op.b1, op.m2, op.b2, op.m3, op.b3, op.md, op.bd]
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert torch.equal(g, w.float())


def _plain_on_operands(x, w1, w2, w3, wd, op):
    """The int8 block on already-quantized weights and the operands'
    vectors, written out plainly."""
    b, h, w, c = x.shape
    mid = w1.shape[1]
    dt = x.dtype
    t = torch.from_numpy

    def quant(v, inv):
        return torch.clamp(torch.round(v.float() * inv), -127, 127).to(
            torch.int8)

    def dequant(acc, m, bias):
        return (acc.float() * m + bias).to(dt)

    xq = quant(x, op.inv[0]).reshape(-1, c)
    y1 = torch.relu(dequant(int_matmul(xq, t(w1)), op.m1, op.b1))
    y1q = quant(y1, op.inv[1]).reshape(b, h, w, mid)
    a2 = conv_s32(y1q, t(w2), (1, 1), ((1, 1), (1, 1))).reshape(-1, mid)
    y2 = torch.relu(dequant(a2, op.m2, op.b2))
    y3 = dequant(int_matmul(quant(y2, op.inv[2]), t(w3)), op.m3, op.b3)
    res = (x.reshape(-1, c) if wd is None
           else dequant(int_matmul(xq, t(wd)), op.md, op.bd))
    return torch.relu(y3 + res).reshape(b, h, w, -1)


@pytest.mark.parametrize("c,mid,o,down", CASES[1::2])
def test_plain_on_unpacked_int8_operands_is_the_plain_version(c, mid, o,
                                                              down):
    ws, scales = _weights(2, c, mid, o, down)
    op = q8.kernel_operands(*ws[:6], *scales, ws[6], ws[7])
    w1, w2, w3, wd, _ = _unpack(op.image.numpy(), c, mid, o, down)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 9, 17, c).astype(np.float32)).to(torch.bfloat16)
    want = q8.fused_bottleneck_int8_infer_plain(x, *ws[:6], *scales, ws[6],
                                                ws[7])
    got = _plain_on_operands(x, w1, w2, w3, wd, op)
    assert torch.equal(got, want)


def test_layout_of_the_path_shapes():
    """The layer1 shape keeps its 72 KB of weights resident beside five
    halo stages; the layer2 shape's 272 KB stream through four stages."""
    l1 = q8.layout(256, 64, 256, False)
    assert (l1.resident, l1.stages, l1.image_bytes, l1.smem) == (
        True, 5, 73728, 231424)
    assert q8.layout(256, 64, 256, True).resident
    l2 = q8.layout(512, 128, 512, False)
    assert (l2.resident, l2.stages, l2.image_bytes, l2.smem) == (
        False, 4, 278528, 203776)
    for c, mid, o, down in CASES:
        lay = q8.layout(c, mid, o, down)
        assert lay.stages >= 2 and lay.smem <= 232448


def test_int8_operands_refuse_widths_the_kernel_does_not_take():
    s = [torch.tensor(0.1)] * 3
    for c, mid, o, down in ((64, 48, 64, False),    # mid 32, 64 or 128
                            (64, 16, 64, False),
                            (64, 32, 96, False),    # identity needs O == C
                            (48, 32, 48, False),    # C a multiple of 32
                            (64, 32, 80, True)):    # O a multiple of 32
        ws, _ = _weights(4, c, mid, o, down)
        with pytest.raises(ValueError):
            q8.kernel_operands(*ws[:6], *s, ws[6], ws[7])
