"""Random-number generation.

Design: *counter-based* streams keyed by global path position, replacing the
reference's per-thread stateful generators (seed-per-thread ``rand_pcg`` +
``xorshift``, src/simulations.cu:33-107,140) and its clock/``random_device``
CPU seeding (src/simulations.cpp:45,100). Counter-based keying makes every
run reproducible and — because the key depends only on the *global* key-tile
index, never on the device — invariant to how paths are sharded over a mesh.
The reference is non-reproducible by construction.

Two families:

1. ``jax.random`` (threefry) keys for the engine; one key per fixed-size
   *key tile* of paths (``KEY_TILE``), folded from (seed, tile_index).
2. For parity experiments and statistical tests, faithful jnp ports of the
   reference's device generators (xorshift — the one its kernels actually
   use, src/simulations.cu:95-98,144-150 — plus HybridTaus and the PCG
   hash seeder); they operate on uint32 lanes exactly like the CUDA
   originals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Paths per RNG key tile. Fixing this constant (rather than deriving it from
# chunk or device count) is what makes results sharding-invariant.
KEY_TILE = 8192

# 2^-32, the u32 -> [0,1) scale the reference uses (src/simulations.cu:58).
U32_TO_UNIT = 2.3283064365386963e-10


def path_tile_keys(root_key: jax.Array, first_tile: jax.Array,
                   n_tiles: int) -> jax.Array:
    """Keys for ``n_tiles`` consecutive global key tiles starting at
    ``first_tile``. Shape (n_tiles,) of keys."""
    tiles = first_tile + jnp.arange(n_tiles, dtype=jnp.uint32)
    return jax.vmap(lambda t: jax.random.fold_in(root_key, t))(tiles)


def uniform_from_bits(bits_u32) -> jax.Array:
    """u32 -> [0, 1) float32 with the reference's scale factor
    (src/simulations.cu:58: ``* 2.3283064e-10``)."""
    return bits_u32.astype(jnp.float32) * jnp.float32(U32_TO_UNIT)


# ---------------------------------------------------------------------------
# Faithful jnp ports of the reference's device PRNGs (parity experiments).
# All state is uint32 arrays; shapes broadcast.
# ---------------------------------------------------------------------------


def pcg_hash(x):
    """The reference's ``rand_pcg`` (src/simulations.cu:62-67).

    Faithful port, including its quirk: the C++ takes ``rng_state`` by
    value, so the LCG advance on line 64 is dead code and the output word
    is computed from the *input* state directly — rand_pcg is a pure hash
    of its argument.
    """
    x = jnp.asarray(x, jnp.uint32)
    word = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x)
    word = word * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def xorshift_step(state):
    """One step of the reference kernels' ``xorshift``
    (src/simulations.cu:70-76, Liao et al. 2020): y ^= y<<11; y ^= y>>7;
    y ^= y>>12. Returns (new_state, new_state) — the reference uses the
    state itself as the draw."""
    y = jnp.asarray(state, jnp.uint32)
    y = y ^ (y << jnp.uint32(11))
    y = y ^ (y >> jnp.uint32(7))
    y = y ^ (y >> jnp.uint32(12))
    return y, y


def xorshift_gm_step(state):
    """George Marsaglia's 13/17/5 xorshift (reference ``xorshiftGM``,
    src/simulations.cu:78-84)."""
    x = jnp.asarray(state, jnp.uint32)
    x = x ^ (x << jnp.uint32(13))
    x = x ^ (x >> jnp.uint32(17))
    x = x ^ (x << jnp.uint32(5))
    return x, x


def xorshf96(x):
    """Faithful port of the reference's ``xorshf96``
    (src/simulations.cu:86-99) — including its quirk: y and z are
    re-initialized to constants on every call, so it is a pure hash of x,
    not a 2^96-period generator as its comment claims."""
    x = jnp.asarray(x, jnp.uint32)
    y = jnp.uint32(362436069)
    z = jnp.uint32(521288629)
    x = x ^ (x << jnp.uint32(16))
    x = x ^ (x >> jnp.uint32(5))
    x = x ^ (x << jnp.uint32(1))
    return x ^ y ^ z  # t=x; x=y; y=z; z=t^x^y with fresh y,z


def taus_step(z, s1, s2, s3, m):
    """TausStep component (src/simulations.cu:39-43, GPU Gems 3 ch. 37)."""
    z = jnp.asarray(z, jnp.uint32)
    b = ((z << jnp.uint32(s1)) ^ z) >> jnp.uint32(s2)
    return ((z & jnp.uint32(m)) << jnp.uint32(s3)) ^ b


def lcg_step(z, a, c):
    """LCGStep component (src/simulations.cu:45-48)."""
    return jnp.asarray(z, jnp.uint32) * jnp.uint32(a) + jnp.uint32(c)


def hybrid_taus_simple_step(state):
    """HybridTausSimple (src/simulations.cu:50-53): two Tausworthe streams,
    ~2^60 period. ``state`` is (..., 2) uint32."""
    z0 = taus_step(state[..., 0], 13, 19, 12, 4294967294)
    z1 = taus_step(state[..., 1], 2, 25, 4, 4294967288)
    return jnp.stack([z0, z1], axis=-1), uniform_from_bits(z0 ^ z1)


def hybrid_taus_simplest_step(state):
    """HybridTausSimplest (src/simulations.cu:55-58): one Tausworthe
    stream, ~2^30 period."""
    z0 = taus_step(jnp.asarray(state, jnp.uint32), 13, 19, 12, 4294967294)
    return z0, uniform_from_bits(z0)


def hybrid_taus_step(state):
    """HybridTaus (src/simulations.cu:50-62): three Tausworthe streams XOR
    one LCG; ~2^121 period. ``state`` is a (..., 4) uint32 array. Returns
    (new_state, uniform_f32_in_[0,1))."""
    z0 = taus_step(state[..., 0], 13, 19, 12, 4294967294)
    z1 = taus_step(state[..., 1], 2, 25, 4, 4294967288)
    z2 = taus_step(state[..., 2], 3, 11, 17, 4294967280)
    z3 = lcg_step(state[..., 3], 1664525, 1013904223)
    new_state = jnp.stack([z0, z1, z2, z3], axis=-1)
    u = uniform_from_bits(z0 ^ z1 ^ z2 ^ z3)
    return new_state, u


def xorshift_stream(seed_per_lane, n_steps: int):
    """Generate ``n_steps`` u32 draws per lane with the reference kernel's
    exact recipe: state0 = pcg_hash(lane_id + 1), then xorshift steps
    (src/simulations.cu:140-146). Returns (..., n_steps) uint32."""
    state0 = pcg_hash(seed_per_lane)

    def body(state, _):
        state, out = xorshift_step(state)
        return state, out

    _, outs = jax.lax.scan(body, state0, None, length=n_steps)
    return jnp.moveaxis(outs, 0, -1)


def bootstrap_index_from_bits(bits_u32, n_table: int):
    """The reference's u32 -> table-index mapping in its exact float32
    arithmetic (src/simulations.cu:148: ``idx = n * (u32 * 2.3283064e-10f)``
    — the truncated literal rounds to exactly 2^-32 in float32, and the
    u32 -> f32 conversion rounds to 24 bits, so this differs from the exact
    integer map ``bootstrap_index_exact`` for ~1e-4 of draws)."""
    u = uniform_from_bits(jnp.asarray(bits_u32, jnp.uint32))
    idx = (u * np.float32(n_table)).astype(jnp.int32)
    return jnp.minimum(idx, n_table - 1)


def bootstrap_index_exact(bits_u32, n_table: int):
    """Exact integer form of the u32 -> index map:
    idx = floor(n * u32 / 2^32), computed as umulhi via a 16-bit split
    (valid for n < 2^15, plenty for the ~1127-row table). The reference's
    float path first rounds u32 to 24 bits (float conversion) — this form
    avoids that rounding."""
    b = jnp.asarray(bits_u32, jnp.uint32)
    h = b >> jnp.uint32(16)
    lo = b & jnp.uint32(0xFFFF)
    n = jnp.uint32(n_table)
    return ((n * h + ((n * lo) >> jnp.uint32(16)))
            >> jnp.uint32(16)).astype(jnp.int32)
