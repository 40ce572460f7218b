"""Small JPEG encoders for the decoder tests: streams that Pillow cannot
write, checked against Pillow's own decoding of the same bytes.

* :func:`arithmetic_jpeg`: arithmetic-coded frames, sequential (SOF9) and
  progressive (SOF10), from given quantised coefficients: libjpeg's QM
  coder and its statistics model (T.81 Annexes D, F and G; ``jcarith.c``),
  with restart intervals and DAC conditioning.
* :func:`lossless_jpeg`: Huffman-coded lossless frames (SOF3): the 7
  predictors, a point transform and restart intervals (T.81 Annex H).

The encoders need only be valid, not good: Pillow decoding the file is the
judge of what it holds.
"""

from __future__ import annotations

import struct

import numpy as np

# Zigzag position -> natural (row-major) index.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Table D.2 as libjpeg packs it (jaricom.c): (Qe, next index after
# an MPS, switch the MPS sense after an LPS, next index after an LPS).
QM = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 0, 14), (0x1114, 3, 0, 16), (0x080b, 4, 0, 18),
    (0x03d8, 5, 0, 20), (0x01da, 6, 0, 23), (0x00e5, 7, 0, 25), (0x006f, 8, 0, 28),
    (0x0036, 9, 0, 30), (0x001a, 10, 0, 33), (0x000d, 11, 0, 35), (0x0006, 12, 0, 9),
    (0x0003, 13, 0, 10), (0x0001, 13, 0, 12), (0x5a7f, 15, 1, 15), (0x3f25, 16, 0, 36),
    (0x2cf2, 17, 0, 38), (0x207c, 18, 0, 39), (0x17b9, 19, 0, 40), (0x1182, 20, 0, 42),
    (0x0cef, 21, 0, 43), (0x09a1, 22, 0, 45), (0x072f, 23, 0, 46), (0x055c, 24, 0, 48),
    (0x0406, 25, 0, 49), (0x0303, 26, 0, 51), (0x0240, 27, 0, 52), (0x01b1, 28, 0, 54),
    (0x0144, 29, 0, 56), (0x00f5, 30, 0, 57), (0x00b7, 31, 0, 59), (0x008a, 32, 0, 60),
    (0x0068, 33, 0, 62), (0x004e, 34, 0, 63), (0x003b, 35, 0, 32), (0x002c, 9, 0, 33),
    (0x5ae1, 37, 1, 37), (0x484c, 38, 0, 64), (0x3a0d, 39, 0, 65), (0x2ef1, 40, 0, 67),
    (0x261f, 41, 0, 68), (0x1f33, 42, 0, 69), (0x19a8, 43, 0, 70), (0x1518, 44, 0, 72),
    (0x1177, 45, 0, 73), (0x0e74, 46, 0, 74), (0x0bfb, 47, 0, 75), (0x09f8, 48, 0, 77),
    (0x0861, 49, 0, 78), (0x0706, 50, 0, 79), (0x05cd, 51, 0, 48), (0x04de, 52, 0, 50),
    (0x040f, 53, 0, 50), (0x0363, 54, 0, 51), (0x02d4, 55, 0, 52), (0x025c, 56, 0, 53),
    (0x01f8, 57, 0, 54), (0x01a4, 58, 0, 55), (0x0160, 59, 0, 56), (0x0125, 60, 0, 57),
    (0x00f6, 61, 0, 58), (0x00cb, 62, 0, 59), (0x00ab, 63, 0, 61), (0x008f, 32, 0, 61),
    (0x5b12, 65, 1, 65), (0x4d04, 66, 0, 80), (0x412c, 67, 0, 81), (0x37d8, 68, 0, 82),
    (0x2fe8, 69, 0, 83), (0x293c, 70, 0, 84), (0x2379, 71, 0, 86), (0x1edf, 72, 0, 87),
    (0x1aa9, 73, 0, 87), (0x174e, 74, 0, 72), (0x1424, 75, 0, 72), (0x119c, 76, 0, 74),
    (0x0f6b, 77, 0, 74), (0x0d51, 78, 0, 75), (0x0bb6, 79, 0, 77), (0x0a40, 48, 0, 77),
    (0x5832, 81, 1, 80), (0x4d1c, 82, 0, 88), (0x438e, 83, 0, 89), (0x3bdd, 84, 0, 90),
    (0x34ee, 85, 0, 91), (0x2eae, 86, 0, 92), (0x299a, 87, 0, 93), (0x2516, 71, 0, 86),
    (0x5570, 89, 1, 88), (0x4ca9, 90, 0, 95), (0x44d9, 91, 0, 96), (0x3e22, 92, 0, 97),
    (0x3824, 93, 0, 99), (0x32b4, 94, 0, 99), (0x2e17, 86, 0, 93), (0x56a8, 96, 1, 95),
    (0x4f46, 97, 0, 101), (0x47e5, 98, 0, 102), (0x41cf, 99, 0, 103), (0x3c3d, 100, 0, 104),
    (0x375e, 93, 0, 99), (0x5231, 102, 0, 105), (0x4c0f, 103, 0, 106), (0x4639, 104, 0, 107),
    (0x415e, 99, 0, 103), (0x5627, 106, 1, 105), (0x50e7, 107, 0, 108), (0x4b85, 103, 0, 109),
    (0x5597, 109, 0, 110), (0x504f, 107, 0, 111), (0x5a10, 111, 1, 110), (0x5522, 109, 0, 112),
    (0x59eb, 111, 1, 112), (0x5a1d, 113, 0, 113),
]
FIXED_BIN = 113


def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dqt(tables) -> bytes:
    body = b""
    for i, q in enumerate(tables):
        body += bytes([i]) + bytes(int(v) for v in np.asarray(q).reshape(64)[ZIGZAG])
    return _seg(0xDB, body)


def _sof(marker, w, h, comps, precision=8) -> bytes:
    body = struct.pack(">BHHB", precision, h, w, len(comps))
    for cid, hs, vs, tq in comps:
        body += bytes([cid, (hs << 4) | vs, tq])
    return _seg(marker, body)


def _sos(ids_tables, ss, se, ah, al) -> bytes:
    body = bytes([len(ids_tables)])
    for cid, td, ta in ids_tables:
        body += bytes([cid, (td << 4) | ta])
    return _seg(0xDA, body + bytes([ss, se, (ah << 4) | al]))


class QMEncoder:
    """libjpeg's arithmetic encoder (``jcarith.c`` arith_encode and
    finish_pass), writing byte-stuffed entropy-coded data."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe, nmps, switch, nlps = QM[sv & 0x7F]
        nl = nlps | (switch << 7)
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        while self.sc:
                            self._emit(0xFF)
                            self._emit(0)
                            self.sc -= 1
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                while self.sc:
                    self._emit(0xFF)
                    self._emit(0)
                    self.sc -= 1
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        out = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return out


def _sar(x, n):
    """Arithmetic right shift of an int (Python's >> already floors)."""
    return x >> n


class _ArithScan:
    """One scan's statistics and the encoding procedures of ``jcarith.c``:
    encode_mcu (sequential), _DC_first, _AC_first, _DC_refine, _AC_refine."""

    def __init__(self, kind, ss, se, ah, al, dac):
        self.kind, self.ss, self.se, self.ah, self.al = kind, ss, se, ah, al
        self.L, self.U, self.K = dac
        self.coder = QMEncoder()
        self.restart_state()

    def restart_state(self):
        self.dc = [[0] * 64 for _ in range(4)]
        self.ac = [[0] * 256 for _ in range(4)]
        self.last_dc = {}
        self.ctx = {}
        self.fixed = [FIXED_BIN]

    def _magnitude(self, st_list, st, v, x_bin):
        """Figures F.8 and F.9 from bin ``st`` with the X bins from
        ``x_bin`` (a list and its start index): ``v`` >= 1."""
        enc = self.coder.encode
        m = 0
        v -= 1
        if v:
            enc(st_list, st, 1)
            m = 1
            v2 = v
            xl, xs = x_bin
            if xl is None:  # DC: X1 = 20 directly
                st = 20
                while v2 >> 1:
                    v2 >>= 1
                    enc(st_list, st, 1)
                    m <<= 1
                    st += 1
            else:
                v2 >>= 1
                if v2:
                    enc(st_list, st, 1)
                    m <<= 1
                    st = xs
                    while v2 >> 1:
                        v2 >>= 1
                        enc(st_list, st, 1)
                        m <<= 1
                        st += 1
        enc(st_list, st, 0)
        return m, v, st

    def dc_block(self, ci, tbl, coef0):
        enc = self.coder.encode
        st_l = self.dc[tbl]
        m = _sar(int(coef0), self.al)
        st = self.ctx.get(ci, 0)
        v = m - self.last_dc.get(ci, 0)
        if v == 0:
            enc(st_l, st, 0)
            self.ctx[ci] = 0
            return
        self.last_dc[ci] = m
        enc(st_l, st, 1)
        if v > 0:
            enc(st_l, st + 1, 0)
            st += 2
            self.ctx[ci] = 4
        else:
            v = -v
            enc(st_l, st + 1, 1)
            st += 3
            self.ctx[ci] = 8
        mm, vv, st = self._magnitude(st_l, st, v, (None, 0))
        if mm < (1 << self.L) >> 1:
            self.ctx[ci] = 0
        elif mm > (1 << self.U) >> 1:
            self.ctx[ci] += 8
        st += 14
        while mm >> 1:
            mm >>= 1
            enc(st_l, st, 1 if (mm & vv) else 0)

    def ac_block(self, tbl, blk):
        """Sequential or AC-first coding of zigzag positions ss..se of
        ``blk`` (natural order) shifted by al."""
        enc = self.coder.encode
        st_l = self.ac[tbl]
        zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
        mag = lambda k: abs(zz[k]) >> self.al  # noqa: E731
        ke = self.se
        while ke > 0 and not mag(ke):
            ke -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            enc(st_l, st, 0)
            while not mag(k):
                enc(st_l, st + 1, 0)
                st += 3
                k += 1
            enc(st_l, st + 1, 1)
            enc(self.fixed, 0, 1 if zz[k] < 0 else 0)
            st += 2
            v = mag(k)
            mm, vv, st = self._magnitude(st_l, st, v, (st_l, 189 if k <= self.K else 217))
            st += 14
            while mm >> 1:
                mm >>= 1
                enc(st_l, st, 1 if (mm & vv) else 0)
            k += 1
        if k <= self.se:
            enc(st_l, 3 * (k - 1), 1)

    def dc_refine(self, coef0):
        self.coder.encode(self.fixed, 0, (int(coef0) >> self.al) & 1)

    def ac_refine(self, tbl, blk):
        enc = self.coder.encode
        st_l = self.ac[tbl]
        zz = [int(blk[ZIGZAG[k]]) for k in range(64)]
        ke = self.se
        while ke > 0 and not (abs(zz[ke]) >> self.al):
            ke -= 1
        kex = ke
        while kex > 0 and not (abs(zz[kex]) >> self.ah):
            kex -= 1
        k = self.ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc(st_l, st, 0)
            while True:
                v = abs(zz[k]) >> self.al
                if v:
                    if v >> 1:
                        enc(st_l, st + 2, v & 1)
                    else:
                        enc(st_l, st + 1, 1)
                        enc(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                enc(st_l, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= self.se:
            enc(st_l, 3 * (k - 1), 1)


def _comp_blocks(w, h, comps):
    """Per component: (blocks across, blocks down) of its non-interleaved
    grid, and the MCU grid (mcux, mcuy, hmax, vmax)."""
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-w // (8 * hmax))
    mcuy = -(-h // (8 * vmax))
    own = [(-(-(-(-w * c[1] // hmax)) // 8), -(-(-(-h * c[2] // vmax)) // 8)) for c in comps]
    return own, (mcux, mcuy, hmax, vmax)


def random_coefficients(w, h, comps, seed, qtables, ac_scale=6.0):
    """Quantised coefficients (by, bx, 64) per component over its whole MCU
    grid: DC a random walk, AC sparse and decaying with frequency, a few
    large, every dequantised value within +-1000 as an 8-bit image's DCT
    gives (libjpeg-turbo's SIMD IDCT, which Pillow runs, leaves the C
    IDCT's results only where 16-bit intermediates overflow)."""
    rng = np.random.default_rng(seed)
    _, (mcux, mcuy, _, _) = _comp_blocks(w, h, comps)
    out = []
    for _, hs, vs, tq in comps:
        lim = 1000 // int(np.max(qtables[tq]))
        by, bx = mcuy * vs, mcux * hs
        c = np.zeros((by, bx, 64), np.int64)
        c[..., 0] = np.clip(np.cumsum(rng.integers(-lim // 8, lim // 8 + 1, (by, bx)), axis=1),
                            -lim, lim)
        freq = np.arange(64)
        scale = ac_scale / (1.0 + freq / 6.0)
        keep = rng.random((by, bx, 64)) < np.exp(-freq / 14.0)
        ac = np.round(rng.normal(0, 1, (by, bx, 64)) * scale).astype(np.int64) * keep
        ac[..., 0] = 0
        c += ac
        # a few large values exercise the long magnitude categories
        big = rng.random((by, bx)) < 0.05
        c[big, 1] = rng.integers(-lim // 2, lim // 2, int(big.sum()))
        out.append(c)
    return out


PROGRESSIVE_SCRIPT = (
    # (component indices or None for all, Ss, Se, Ah, Al)
    (None, 0, 0, 0, 1),
    ("each", 1, 5, 0, 2),
    ("each", 6, 63, 0, 2),
    ("each", 1, 63, 2, 1),
    (None, 0, 0, 1, 0),
    ("each", 1, 63, 1, 0),
)


def arithmetic_jpeg(w, h, comps, coefs, qtables, progressive=False, restart=0, dac=None,
                    app=b"", ids_rgb=False) -> bytes:
    """An arithmetic-coded JPEG of ``w`` x ``h``: ``comps`` a list of
    (id, h, v, quant table), ``coefs`` per component an (by, bx, 64)
    integer array in natural order over its MCU grid, ``restart`` the
    restart interval in MCUs (or blocks, in a one-component scan), ``dac``
    (L, U, K) conditioning for every table (None: the defaults 0, 1, 5,
    no DAC segment). SOF9, or SOF10 with :data:`PROGRESSIVE_SCRIPT`."""
    L, U, K = dac if dac is not None else (0, 1, 5)
    out = b"\xff\xd8" + app + _dqt(qtables)
    out += _sof(0xCA if progressive else 0xC9, w, h, comps)
    if dac is not None:
        body = b""
        for t in range(len(comps)):
            body += bytes([t, (U << 4) | L, 0x10 | t, K])
        out += _seg(0xCC, body)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    own, (mcux, mcuy, hmax, vmax) = _comp_blocks(w, h, comps)
    script = PROGRESSIVE_SCRIPT if progressive else ((None, 0, 63, 0, 0),)
    for sel, ss, se, ah, al in script:
        groups = [list(range(len(comps)))] if sel is None else [[c] for c in range(len(comps))]
        for group in groups:
            if progressive:
                kind = ("dc_first" if ah == 0 else "dc_refine") if ss == 0 else (
                    "ac_first" if ah == 0 else "ac_refine")
            else:
                kind = "seq"
            scan = _ArithScan(kind, max(ss, 1), se, ah, al, (L, U, K))
            out += _sos([(comps[c][0], c, c) for c in group], ss, se, ah, al)
            units = []  # (ci, by, bx) per coding unit, in order, grouped per MCU
            if len(group) == 1:
                c = group[0]
                bw, bh = own[c]
                units = [[(c, y, x)] for y in range(bh) for x in range(bw)]
            else:
                for my in range(mcuy):
                    for mx in range(mcux):
                        mcu = []
                        for c in group:
                            _, hs, vs, _ = comps[c]
                            for y in range(vs):
                                for x in range(hs):
                                    mcu.append((c, my * vs + y, mx * hs + x))
                        units.append(mcu)
            data = b""
            for i, mcu in enumerate(units):
                if restart and i and i % restart == 0:
                    data += scan.coder.finish() + bytes([0xFF, 0xD0 + ((i // restart - 1) & 7)])
                    scan.restart_state()
                for c, y, x in mcu:
                    blk = coefs[c][y, x]
                    if kind in ("seq", "dc_first"):
                        scan.dc_block(c, c, blk[0])
                        if kind == "seq":
                            scan.ac_block(c, blk)
                    elif kind == "dc_refine":
                        scan.dc_refine(blk[0])
                    elif kind == "ac_first":
                        scan.ac_block(c, blk)
                    else:
                        scan.ac_refine(c, blk)
            out += data + scan.coder.finish()
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Lossless (SOF3), Huffman-coded
# ---------------------------------------------------------------------------


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out = bytes(self.out)
        self.out = bytearray()
        return out


def _huff_table(counts):
    """Code lengths 1..16 (counts) -> (code, length) per symbol order."""
    codes, code = [], 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes.append((code, length))
            code += 1
        code <<= 1
    return codes


# Difference categories 0..16: 17 symbols, 14 codes of 4 bits and 3 of 5
# (no code all ones, as libjpeg requires).
_LL_COUNTS = [0, 0, 0, 14, 3] + [0] * 11
_LL_SYMS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]


def _predict(p, ra, rb, rc):
    if p == 1:
        return ra
    if p == 2:
        return rb
    if p == 3:
        return rc
    if p == 4:
        return ra + rb - rc
    if p == 5:
        return ra + ((rb - rc) >> 1)
    if p == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_jpeg(img, predictor, pt=0, restart=0, ids=(1, 2, 3), app=b"", sampling=None) -> bytes:
    """A lossless (SOF3) JPEG of an (H, W) or (H, W, C) uint8 image,
    interleaved in one scan: ``predictor`` 1-7, point transform ``pt``,
    ``restart`` interval in MCUs (a restart interval of whole MCU rows, as
    libjpeg needs). ``sampling``: each component's (h, v) factors (default
    1x1 each); a component sampled below the largest factors takes every
    (hmax / h)-th column and (vmax / v)-th row of its channel, and an
    interleaved MCU codes h x v samples of it, the samples past the
    component's edge (T.81 A.2.4's dummy data units) repeating its last
    column and row."""
    img = np.asarray(img, np.int64)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    sampling = [(1, 1)] * nc if sampling is None else list(sampling)
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = (w + hmax - 1) // hmax, (h + vmax - 1) // vmax
    if nc == 1:  # a one-component scan codes the component's own samples
        mcux, mcuy, hmax, vmax, sampling = w, h, 1, 1, [(1, 1)]
    planes = []
    for c, (hs, vs) in enumerate(sampling):
        cw, ch = (w * hs + hmax - 1) // hmax, (h * vs + vmax - 1) // vmax
        plane = (img[:, :, c] >> pt)[::vmax // vs, ::hmax // hs][:ch, :cw]
        planes.append(np.pad(plane, ((0, mcuy * vs - ch), (0, mcux * hs - cw)), mode="edge"))
    codes = dict(zip(_LL_SYMS, _huff_table(_LL_COUNTS)))
    dht = b""
    for t in range(nc):
        dht += _seg(0xC4, bytes([t]) + bytes(_LL_COUNTS) + bytes(_LL_SYMS))
    out = b"\xff\xd8" + app
    out += _sof(0xC3, w, h, [(ids[c] if nc > 1 else 1, *sampling[c], 0) for c in range(nc)]) + dht
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    out += _sos([(ids[c] if nc > 1 else 1, c, 0) for c in range(nc)], predictor, 0, 0, pt)
    bits = _Bits()
    data = b""
    first_row = 0  # the MCU row that starts the restart interval
    n_mcu = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + ((n_mcu // restart - 1) & 7)])
                first_row = my
            n_mcu += 1
            for c, (hs, vs) in enumerate(sampling):
                x = planes[c]
                for yy in range(my * vs, my * vs + vs):
                    for xx in range(mx * hs, mx * hs + hs):
                        if yy == first_row * vs:
                            pred = (1 << (8 - pt - 1)) if xx == 0 else x[yy, xx - 1]
                        elif xx == 0:
                            pred = x[yy - 1, xx]
                        else:
                            pred = _predict(predictor, x[yy, xx - 1], x[yy - 1, xx],
                                            x[yy - 1, xx - 1])
                        diff = int(x[yy, xx] - pred) & 0xFFFF
                        if diff >= 0x8000:
                            diff -= 0x10000
                        ssss = 16 if diff == -32768 else int(abs(diff)).bit_length()
                        code, length = codes[ssss]
                        bits.put(code, length)
                        if 0 < ssss < 16:
                            bits.put(diff if diff > 0 else diff + (1 << ssss) - 1, ssss)
    data += bits.flush()
    return out + data + b"\xff\xd9"
