"""The operands of the bf16 fused-bottleneck kernel (K1, K2) on the CPU.

``kernel_operands`` lays the folded weights out as the CUDA kernel reads
them (swizzled K-major panels, K zero-padded, conv3's columns reordered).
The kernel runs only on the card; here a plain inverse, written from the
layout's description and not from the packing code, unpacks the image and
must give back the bf16 weights bit for bit, with zeros everywhere the
layout pads, and the plain version on the unpacked weights must equal the
plain version on the originals.
"""

import numpy as np
import pytest
import torch

from dir_tpu_torch.ops import fused_bottleneck as fb

# (C, mid, O, projection, bands): mid 16/32/64/128, C and O not multiples of
# 64, both residual forms, both kernel forms
CASES = [
    (48, 16, 48, False, 0),
    (32, 16, 64, True, 0),
    (80, 32, 80, False, 2),
    (144, 64, 80, True, 2),
    (256, 64, 256, False, 0),
    (256, 64, 256, True, 0),
    (208, 128, 208, False, 4),
    (96, 128, 160, True, 4),
]


def _weights(seed, c, mid, o, down):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    ws = [t(c, mid), t(mid), t(3, 3, mid, mid), t(mid), t(mid, o), t(o)]
    return ws + ([t(c, o), t(o)] if down else [None, None])


def _unswizzle(panel: np.ndarray) -> np.ndarray:
    """(R, 64) as stored -> as meant: the 16-byte chunk c of row r sits at
    chunk c ^ (r % 8)."""
    r = panel.shape[0]
    out = np.empty_like(panel)
    for row in range(r):
        for c in range(8):
            out[row, c * 8:(c + 1) * 8] = panel[row, (c ^ (row % 8)) * 8:
                                                (c ^ (row % 8)) * 8 + 8]
    return out


def _take(image, at, n_panels, rows):
    """``n_panels`` consecutive (rows, 64) panels from ``at``, unswizzled and
    joined along K: (rows, 64 * n_panels); returns it and the next offset."""
    size = rows * 64
    panels = [_unswizzle(image[at + i * size: at + (i + 1) * size]
                         .reshape(rows, 64)) for i in range(n_panels)]
    return np.concatenate(panels, axis=1), at + n_panels * size


def _unpack(image: np.ndarray, c, mid, o, down):
    """The plain inverse of the layout: w1, w2, w3, wd (K, N as the folded
    weights) and the padding that must be zero."""
    nk, kp = -(-c // 64), -(-mid // 64)
    n3 = max(32, mid)
    op = -(-o // n3) * n3
    # the kernel's column order: column 32q + 8jj + 2tig + e holds channel
    # 32q + 8tig + 2jj + e
    col = np.arange(op)
    q, r = col // 32, col % 32
    chan = 32 * q + 8 * ((r % 8) // 2) + 2 * (r // 8) + r % 2
    pads = []
    at = 0
    w1t, at = _take(image, at, nk, mid)                 # (mid, C padded)
    pads.append(w1t[:, c:])
    w2 = np.empty((3, 3, mid, mid), image.dtype)
    for t in range(9):
        tap, at = _take(image, at, kp, mid)             # (mid out, mid in padded)
        pads.append(tap[:, mid:])
        w2[t // 3, t % 3] = tap[:, :mid].T

    def chunks(k_panels):
        nonlocal at
        rows = []
        for _ in range(op // n3):
            blk, at = _take(image, at, k_panels, n3)    # (n3 columns, K padded)
            rows.append(blk)
        cols = np.concatenate(rows, axis=0)             # (Op, K padded)
        out = np.zeros((op, cols.shape[1]), image.dtype)
        out[chan] = cols
        return out

    w3r = chunks(kp)
    pads += [w3r[:, mid:], w3r[o:]]
    w3 = w3r[:o, :mid].T
    wd = None
    if down:
        wdr = chunks(nk)
        pads += [wdr[:, c:], wdr[o:]]
        wd = wdr[:o, :c].T
    assert at == image.size, "image longer than its layout"
    return w1t[:, :c].T, w2, w3, wd, pads


@pytest.mark.parametrize("c,mid,o,down,bands", CASES)
def test_operands_unpack_to_the_bf16_weights(c, mid, o, down, bands):
    ws = _weights(1, c, mid, o, down)
    op = fb.kernel_operands(*ws, bands=bands)
    assert op.image.dtype == torch.bfloat16
    assert (op.c, op.mid, op.o, op.bands) == (c, mid, o, bands)
    image = op.image.view(torch.int16).numpy()          # compare the bits
    w1, w2, w3, wd, pads = _unpack(image, c, mid, o, down)
    bits = [w.to(torch.bfloat16).view(torch.int16).numpy()
            for w in (ws[0], ws[2], ws[4])]
    np.testing.assert_array_equal(w1, bits[0])
    np.testing.assert_array_equal(w2, bits[1])
    np.testing.assert_array_equal(w3, bits[2])
    if down:
        np.testing.assert_array_equal(
            wd, ws[6].to(torch.bfloat16).view(torch.int16).numpy())
    for p in pads:
        assert not p.any()
    for got, want in zip((op.b1, op.b2, op.b3, op.bd), ws[1::2]):
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("c,mid,o,down,bands", CASES[::2])
def test_plain_on_unpacked_operands_is_the_plain_version(c, mid, o, down,
                                                         bands):
    ws = _weights(2, c, mid, o, down)
    op = fb.kernel_operands(*ws, bands=bands)
    w1, w2, w3, wd, _ = _unpack(op.image.view(torch.int16).numpy(), c, mid, o,
                                down)

    def bf(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).view(torch.bfloat16)

    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 9, 17, c).astype(np.float32)).to(torch.bfloat16)
    want = fb.fused_bottleneck_infer_plain(x, *ws)
    got = fb.fused_bottleneck_infer_plain(x, bf(w1), op.b1, bf(w2), op.b2,
                                          bf(w3), op.b3, bf(wd), op.bd)
    assert torch.equal(got, want)


def test_channel_order_groups_eight_consecutive_channels():
    order = fb.channel_order(96)
    assert sorted(order.tolist()) == list(range(96))
    # a thread (tig) holds columns 8jj + 2tig + e of each 32: channels
    # 8tig .. 8tig + 7 in order
    for q in range(3):
        for tig in range(4):
            cols = [32 * q + 8 * jj + 2 * tig + e for jj in range(4)
                    for e in range(2)]
            assert order[cols].tolist() == list(range(32 * q + 8 * tig,
                                                      32 * q + 8 * tig + 8))


def test_operands_refuse_widths_the_kernel_does_not_take():
    """mid must be 16, 32, 64 or 128 and the identity residual needs O == C;
    the layer2 widths are laid out for either form (the resident form's
    shared memory is checked where the kernel is launched)."""
    ws = _weights(4, 512, 128, 512, False)
    for bands in (0, 4):
        assert fb.kernel_operands(*ws, bands=bands).image.numel() * 2 == 557056
    with pytest.raises(ValueError):      # mid must be 16, 32, 64 or 128
        fb.kernel_operands(*_weights(4, 64, 48, 64, False), bands=0)
    with pytest.raises(ValueError):      # identity residual needs O == C
        fb.kernel_operands(*_weights(4, 64, 32, 96, False), bands=0)
    with pytest.raises(ValueError):      # C a multiple of 16
        fb.kernel_operands(*_weights(4, 40, 32, 40, False), bands=0)
