"""Sobol quasi-Monte-Carlo on device.

The reference vendors two CPU Sobol generators — Burkardt's table-driven
i4/i8 implementation (include/sobol/sobol.cpp) and Joe–Kuo's gray-code
generator driven by a direction-numbers file (include/sobol_joekuo/
sobol.cc:74-166) — but never wires either into the simulators
(src/simulations.cu:136-137 is a TODO). Here Sobol is a first-class sampler.

Three deliberate design departures from the reference:

1. **Direction numbers are generated, not vendored.** Primitive polynomials
   over GF(2) are found algorithmically (order test on x in GF(2^d)) and
   initial direction values are deterministic pseudo-random odd integers
   from a fixed seed. Every 1-D projection is then an exact (0,1)-sequence
   in base 2 regardless of the initial values, and the default random
   digital shift removes any residual cross-dimension artifacts. No
   upstream data tables are copied.

2. **Random access instead of the serial gray-code recurrence.** Point i is
   the XOR of direction numbers over the set bits of gray(i) = i ^ (i >> 1)
   — a 32-step branch-free select/XOR chain on the VPU — so any path/chip
   can compute its own points with no sequential dependence (the serial
   recurrence of sobol.cc:117-165 cannot shard).

3. **Scrambling.** A per-seed random digital shift (XOR) per dimension makes
   repeated runs independent and unbiased while preserving the net
   structure. Pass a zero scramble key for the raw sequence (used by the
   tests to cross-check against the C++ generator in csrc/).
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

MAX_DEGREE = 14  # degrees 2..14 yield 2864 dims + dim 0 => up to 2865 dims
_M_SEED = 0x5350_4F42  # deterministic seed for initial direction values

# ---------------------------------------------------------------------------
# GF(2) polynomial arithmetic on int bitmasks (host, setup-time only).
# ---------------------------------------------------------------------------


def _gf2_mulmod(a: int, b: int, p: int, d: int) -> int:
    """(a*b) mod p over GF(2), p of degree d."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> d & 1:
            a ^= p
    return r


def _gf2_powmod(a: int, e: int, p: int, d: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf2_mulmod(r, a, p, d)
        a = _gf2_mulmod(a, a, p, d)
        e >>= 1
    return r


def _prime_factors(n: int):
    out = []
    f = 2
    while f * f <= n:
        if n % f == 0:
            out.append(f)
            while n % f == 0:
                n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def _primitive_polys_of_degree(d: int):
    """All primitive polynomials of degree d over GF(2), as bitmasks
    (bit i = coefficient of x^i), in increasing numeric order."""
    order = (1 << d) - 1
    cofactors = [order // q for q in _prime_factors(order)]
    out = []
    # constant term must be 1; total weight must be odd (else divisible by x+1)
    for mask in range((1 << d) | 1, 1 << (d + 1), 2):
        if bin(mask).count("1") % 2 == 0:
            continue
        if _gf2_powmod(2, order, mask, d) != 1:  # x^order != 1 => not even irreducible-with-primitive-x
            continue
        if any(_gf2_powmod(2, c, mask, d) == 1 for c in cofactors):
            continue
        out.append(mask)
    return out


@lru_cache(maxsize=1)
def primitive_polynomials() -> np.ndarray:
    """uint32 bitmasks of primitive polynomials, degrees 2..MAX_DEGREE,
    ordered by (degree, mask). Cached on disk after first computation."""
    cache = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        f"_sobol_polys_d{MAX_DEGREE}.npy",
    )
    if os.path.exists(cache):
        return np.load(cache)
    polys = []
    for d in range(2, MAX_DEGREE + 1):
        polys.extend(_primitive_polys_of_degree(d))
    arr = np.asarray(polys, np.uint32)
    try:
        np.save(cache, arr)
    except OSError:
        pass
    return arr


def _poly_degree(mask: int) -> int:
    return mask.bit_length() - 1


INDEX_BITS = 64  # i8-parity sequence depth (reference i8_sobol: 2^62
#                  indices, include/sobol/sobol.cpp:14191)


@lru_cache(maxsize=32)
def direction_numbers_u64(dims: int) -> np.ndarray:
    """(dims, 64) uint64 direction numbers as 0.64 fixed point.

    Entry [d][k] is XORed into the point when bit k of gray(index) is set;
    indices up to 2^62 are supported (parity with the reference's i8_sobol
    depth, include/sobol/sobol.cpp:14191 — its i4 path stops at 2^30).
    The top 32 bits of the first 32 entries reproduce the 32-bit table
    exactly, so 64-bit indexing is a strict extension: the same sequence
    positions give the same f32 points.
    """
    polys = primitive_polynomials()
    if dims - 1 > len(polys):
        raise ValueError(
            f"sobol: {dims} dims requested, only {len(polys) + 1} supported"
        )
    rng = np.random.default_rng(_M_SEED)
    nb = INDEX_BITS
    v = np.zeros((dims, nb), np.uint64)
    # dimension 0: van der Corput — m_k = 1 for all k
    v[0] = np.uint64(1) << (nb - 1 - np.arange(nb, dtype=np.uint64))
    mask64 = (1 << 64) - 1
    for dim in range(1, dims):
        p = int(polys[dim - 1])
        s = _poly_degree(p)
        # initial values: m_i odd, uniform in [1, 2^i) — the SAME draws as
        # the 32-bit table (one rng call per value, same order)
        m = [int(rng.integers(0, 1 << max(i - 1, 0))) * 2 + 1
             for i in range(1, s + 1)]
        for k in range(s, nb):
            new = m[k - s] ^ (m[k - s] << s)
            for j in range(1, s):
                if (p >> (s - j)) & 1:
                    new ^= m[k - j] << j
            m.append(new & mask64)
        mk = np.asarray(m[:nb], object)  # m_k up to k bits wide
        v[dim] = np.asarray(
            [(int(mk[k]) << (nb - 1 - k)) & mask64 for k in range(nb)],
            np.uint64,
        )
    return v


@lru_cache(maxsize=32)
def direction_numbers(dims: int) -> np.ndarray:
    """(dims, 32) uint32 direction numbers V[d][k] for bit k (MSB-scaled:
    point = XOR of V over set bits of gray(i), as a 0.32 fixed-point).
    Equal to the top 32 bits of the first 32 columns of the 64-bit table."""
    return (direction_numbers_u64(dims)[:, :32] >> np.uint64(32)).astype(
        np.uint32
    )


@lru_cache(maxsize=32)
def direction_numbers_hi32(dims: int) -> np.ndarray:
    """(dims, 64) uint32: top-32 bits of every 64-bit direction number —
    the device table for 64-bit sequence indices with f32 points (XOR
    commutes with truncation, so folding truncated directions gives the
    exact top-32 bits of the 0.64 fixed-point value)."""
    return (direction_numbers_u64(dims) >> np.uint64(32)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Device-side point generation.
# ---------------------------------------------------------------------------


def digital_shift(scramble_key, dims: int) -> jax.Array:
    """(dims,) uint32 per-dimension XOR shift; all-zeros for a zero key."""
    bits = jax.random.bits(scramble_key, (dims,), jnp.uint32)
    is_zero = jnp.all(
        jax.random.key_data(scramble_key) == 0
    )
    return jnp.where(is_zero, jnp.uint32(0), bits)


def sobol_bits(direction, index) -> jax.Array:
    """Raw Sobol integers for sequence positions ``index``.

    direction: (dims, 32) uint32. index: (...,) uint32 global positions.
    Returns (..., dims) uint32. Branch-free XOR fold over the 32 bits of
    gray(index) — vectorizes perfectly.
    """
    direction = jnp.asarray(direction, jnp.uint32)
    idx = jnp.asarray(index, jnp.uint32)
    gray = idx ^ (idx >> jnp.uint32(1))
    acc = jnp.zeros(idx.shape + (direction.shape[0],), jnp.uint32)
    for b in range(32):
        bit = ((gray >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.bool_)
        acc = jnp.where(bit[..., None], acc ^ direction[:, b], acc)
    return acc


def sobol_bits64(direction_hi32, idx_lo, idx_hi) -> jax.Array:
    """Raw Sobol integers (top 32 bits) for 64-bit sequence positions.

    direction_hi32: (dims, 64) uint32 (see direction_numbers_hi32).
    idx_lo/idx_hi: (...,) uint32 words of the 64-bit index. Returns
    (..., dims) uint32 — exactly the top-32 bits of the full 0.64 point,
    since XOR commutes with truncation. For idx_hi == 0 this equals
    sobol_bits over the 32-bit table at the same positions.
    """
    direction = jnp.asarray(direction_hi32, jnp.uint32)
    lo = jnp.asarray(idx_lo, jnp.uint32)
    hi = jnp.asarray(idx_hi, jnp.uint32)
    # 64-bit gray code across the word boundary
    glo = lo ^ ((lo >> jnp.uint32(1)) | (hi << jnp.uint32(31)))
    ghi = hi ^ (hi >> jnp.uint32(1))
    acc = jnp.zeros(lo.shape + (direction.shape[0],), jnp.uint32)
    for b in range(32):
        bit = ((glo >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.bool_)
        acc = jnp.where(bit[..., None], acc ^ direction[:, b], acc)
    for b in range(32):
        bit = ((ghi >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.bool_)
        acc = jnp.where(bit[..., None], acc ^ direction[:, 32 + b], acc)
    return acc


def _split_index64(index_offset: int, first_index, n: int):
    """(lo, hi) uint32 word pairs for positions index_offset + first_index
    + [0, n) with explicit carries (first_index may be a traced uint32)."""
    if not 0 <= index_offset < 1 << 62:
        raise ValueError(
            f"sobol index_offset must be in [0, 2^62), got {index_offset}"
        )
    off_lo = jnp.uint32(index_offset & 0xFFFFFFFF)
    off_hi = jnp.uint32(index_offset >> 32)
    base_lo = off_lo + jnp.asarray(first_index, jnp.uint32)
    base_hi = off_hi + (base_lo < off_lo).astype(jnp.uint32)
    ar = jnp.arange(n, dtype=jnp.uint32)
    lo = base_lo + ar
    hi = base_hi + (lo < base_lo).astype(jnp.uint32)
    return lo, hi


def sobol_points_f32(direction, first_index, n: int, dims: int,
                     scramble_key=None, index_offset: int = 0) -> jax.Array:
    """(n, dims) scrambled Sobol points in [0, 1), float32.

    ``first_index`` may be traced (global path offset); ``n``/``dims`` are
    static. ``index_offset`` (static, < 2^62) shifts the whole run deeper
    into the sequence — with a (dims, 64) direction table this gives the
    reference i8_sobol's index depth (include/sobol/sobol.cpp:14191); the
    reference's own sobol_points (sobol_joekuo/sobol.cc:74-166) is serial,
    host-only, and 32-bit.
    """
    bits = sobol_bits_u32(direction, first_index, n, dims, scramble_key,
                          index_offset)
    # u32 -> [0,1): same 2^-32 scale the reference kernels use. Words
    # >= 2^32 - 128 round UP to exactly 1.0f in the u32->f32 convert
    # (p ~ 3e-8 per draw — thousands of hits at 100M x 360), which would
    # break the documented [0,1) contract; clamp to the largest f32
    # below 1, as the f64 paths do (sobol_points_f64*).
    pts = bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)
    return jnp.minimum(pts, jnp.float32(1.0 - 2.0**-24))


def sobol_bits_u32(direction, first_index, n: int, dims: int,
                   scramble_key=None, index_offset: int = 0) -> jax.Array:
    """(n, dims) scrambled Sobol words as uint32 — the integer form behind
    sobol_points_f32, for consumers that need exact integer maps (the
    historical-bootstrap index uses floor(n * word / 2^32), which must be
    computed on the WORD, not on a rounded float)."""
    direction = jnp.asarray(direction, jnp.uint32)[:dims]
    deep = index_offset != 0 or direction.shape[-1] == 64
    if deep:
        if direction.shape[-1] != 64:
            raise ValueError(
                "index_offset beyond 0 needs a (dims, 64) direction table "
                "(ops.sobol.direction_numbers_hi32)"
            )
        lo, hi = _split_index64(index_offset, first_index, n)
        bits = sobol_bits64(direction, lo, hi)
    else:
        idx = jnp.asarray(first_index, jnp.uint32) + jnp.arange(
            n, dtype=jnp.uint32
        )
        bits = sobol_bits(direction, idx)
    if scramble_key is not None:
        bits = bits ^ digital_shift(scramble_key, dims)[None, :]
    return bits


@lru_cache(maxsize=32)
def direction_numbers_split(dims: int):
    """((dims, 64) hi, (dims, 64) lo) uint32 word pairs of the 64-bit
    direction numbers — the device tables for full-precision f64 points
    (XOR has no carries, so the 64-bit fold decomposes exactly into two
    independent 32-bit folds)."""
    v = direction_numbers_u64(dims)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def _gray64(idx_lo, idx_hi):
    lo = jnp.asarray(idx_lo, jnp.uint32)
    hi = jnp.asarray(idx_hi, jnp.uint32)
    glo = lo ^ ((lo >> jnp.uint32(1)) | (hi << jnp.uint32(31)))
    ghi = hi ^ (hi >> jnp.uint32(1))
    return glo, ghi


def sobol_bits64_pair(dir_hi, dir_lo, idx_lo, idx_hi):
    """((..., dims) hi, (..., dims) lo) uint32 words of the FULL 0.64
    fixed-point Sobol integers at 64-bit sequence positions — the
    on-device form behind sobol_points_f64. Same branch-free gray-code
    fold as sobol_bits64, accumulated in two carry-free words."""
    dir_hi = jnp.asarray(dir_hi, jnp.uint32)
    dir_lo = jnp.asarray(dir_lo, jnp.uint32)
    glo, ghi = _gray64(idx_lo, idx_hi)
    shape = glo.shape + (dir_hi.shape[0],)
    acc_h = jnp.zeros(shape, jnp.uint32)
    acc_l = jnp.zeros(shape, jnp.uint32)
    for b in range(32):
        bit = ((glo >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.bool_)
        take = bit[..., None]
        acc_h = jnp.where(take, acc_h ^ dir_hi[:, b], acc_h)
        acc_l = jnp.where(take, acc_l ^ dir_lo[:, b], acc_l)
    for b in range(32):
        bit = ((ghi >> jnp.uint32(b)) & jnp.uint32(1)).astype(jnp.bool_)
        take = bit[..., None]
        acc_h = jnp.where(take, acc_h ^ dir_hi[:, 32 + b], acc_h)
        acc_l = jnp.where(take, acc_l ^ dir_lo[:, 32 + b], acc_l)
    return acc_h, acc_l


def sobol_points_f64(dims: int, first_index, n: int,
                     scramble_key=None, index_offset: int = 0):
    """(n, dims) float64 Sobol points at full 64-bit precision, computed
    ON DEVICE — the device-side analog of the reference's i8_sobol f64
    output (include/sobol/sobol.cpp:14191; its generator is serial and
    host-only). The integer fold is pure uint32; only the
    final combine needs float64, so jax_enable_x64 must be on (use
    ``with jax.enable_x64(True):`` or run the fold via
    sobol_bits64_pair and combine on the host). Bit-identical to
    sobol_points_f64_host: (hi * 2^32 + lo) rounds the exact 64-bit
    integer to the nearest f64 exactly as the host's u64 conversion does.
    """
    from jax import dtypes

    if dtypes.canonicalize_dtype(jnp.float64) != jnp.float64:
        raise ValueError(
            "sobol_points_f64 needs float64: enable it with "
            "`with jax.enable_x64(True): ...` (the integer "
            "fold itself is uint32; see sobol_bits64_pair for a "
            "combine-on-host alternative)"
        )
    dir_hi, dir_lo = direction_numbers_split(dims)
    lo, hi = _split_index64(index_offset, first_index, n)
    acc_h, acc_l = sobol_bits64_pair(dir_hi, dir_lo, lo, hi)
    if scramble_key is not None:
        # 64-bit digital shift: an independent word per half, both gated
        # on the ORIGINAL key's zero-ness (zero key == raw sequence)
        is_zero = jnp.all(jax.random.key_data(scramble_key) == 0)
        sh = jax.random.bits(scramble_key, (dims,), jnp.uint32)
        sl = jax.random.bits(
            jax.random.fold_in(scramble_key, 0x64), (dims,), jnp.uint32
        )
        acc_h = acc_h ^ jnp.where(is_zero, jnp.uint32(0), sh)[None, :]
        acc_l = acc_l ^ jnp.where(is_zero, jnp.uint32(0), sl)[None, :]
    out = (
        acc_h.astype(jnp.float64) * jnp.float64(2.0**32)
        + acc_l.astype(jnp.float64)
    ) * jnp.float64(2.0**-64)
    # integers within 1024 of 2^64 round UP to 2^64 in float64 and would
    # emit exactly 1.0, breaking the [0,1) contract (p ~ 5.5e-17/point
    # but reachable under scrambling); clamp to the largest f64 below 1
    return jnp.minimum(out, jnp.float64(1.0 - 2.0**-53))


def sobol_points_f64_host(dims: int, offset: int, n: int) -> np.ndarray:
    """(n, dims) float64 points at full 64-bit precision (host/numpy) —
    the analytic-depth parity surface for the reference's i8_sobol f64
    output (include/sobol/sobol.cpp:14191). Device paths use f32."""
    v = direction_numbers_u64(dims)
    idx = np.arange(offset, offset + n, dtype=np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    acc = np.zeros((n, dims), np.uint64)
    for b in range(INDEX_BITS):
        take = (gray >> np.uint64(b)) & np.uint64(1)
        acc ^= np.where(take[:, None].astype(bool), v[None, :, b], 0)
    out = acc.astype(np.float64) * (2.0 ** -64)
    # same top-of-range rounding guard as sobol_points_f64 (bit parity)
    return np.minimum(out, 1.0 - 2.0**-53)


# Bratley-Fox "favorable" starting-seed exponents (reference
# include/sobol/sobol.cpp:28467 tau_sobol; Algorithm 659, ACM TOMS 14(1)).
_TAU_TABLE = (0, 0, 1, 3, 5, 8, 11, 15, 19, 23, 27, 31, 35)


def tau_sobol(dim_num: int) -> int:
    """Favorable starting-seed exponent TAU for a ``dim_num``-dimensional
    Sobol sequence, or -1 outside the published 1..13 table (reference
    parity: include/sobol/sobol.cpp:28467-28560). For integration,
    starting the sequence at index N = 2**K with K >= TAU + dim_num - 1
    improves low-index uniformity; pass ``favorable_index_offset`` as the
    model's ``index_offset`` to apply it."""
    if 1 <= dim_num <= len(_TAU_TABLE):
        return _TAU_TABLE[dim_num - 1]
    return -1


def favorable_index_offset(dim_num: int) -> int:
    """The smallest favorable start N = 2**(TAU + dim_num - 1) for
    integration use, or 0 when the table has no entry (dims > 13 — at
    engine scale the burn-in is immaterial anyway)."""
    tau = tau_sobol(dim_num)
    if tau < 0:
        return 0
    return 1 << (tau + dim_num - 1)
