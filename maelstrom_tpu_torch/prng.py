"""The simulation's random numbers: threefry2x32, bit for bit with
`jax.random` (jax 0.9.0, `jax_threefry_partitionable` on, its default).

A key is a `uint32[2]` tensor on the simulation's device, as JAX's raw
key is. What JAX computes:

  - `PRNGKey(seed)`: (seed >> 32, seed & 0xFFFFFFFF) (`jax/_src/prng.py`
    `threefry_seed`);
  - `split(key, n)`: the n raw pairs threefry2x32(key, (0, i)), i < n
    (`_threefry_split_foldlike` over `iota_2x32_shape`);
  - `fold_in(key, d)`: the pair threefry2x32(key, (0, d));
  - 32 random bits at flat index i of a shape: bits1 ^ bits2 of
    threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
    (`_threefry_random_bits_partitionable`);
  - `uniform`: (bits >> 9 | 0x3f800000) read as a float32, minus 1.0;
  - `exponential`: -log1p(-u);
  - `randint` (int32): two streams of bits from `split(key)`, combined
    modulo the span as `jax/_src/random.py` `_randint` does, in uint32
    arithmetic that wraps.

The plain versions do the 32-bit arithmetic in int64 masked to 32 bits
(torch has no uint32 shift on the CPU). On the card one kernel, K7
`threefry` (`csrc/prng.cu`), makes a key's split, its bits, uniforms,
`u < p` masks or latency rounds in one launch; the edge fault kernel K8
(`csrc/faults.cu`) shares its device threefry (`csrc/common.cuh`).

Exponential floats depend on the `log1p` of the platform (XLA's CPU
one, torch's, CUDA's `log1pf` are not all correctly rounded), so they
agree within an ulp or so, and their latency rounds agree except where
a product lands within an ulp of a .5 tie."""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import kernels as K

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# K7 modes (csrc/prng.cu)
SPLIT, BITS, UNIFORM, MASK, LATENCY = range(5)
DISTS = {"constant": 0, "uniform": 1, "exponential": 2}


# --- plain versions --------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under the key (k0, k1): int64 tensors holding uint32 values, which
    broadcast (keys [k, 1] against counters [n] hash k streams at once).
    Returns the two output words as int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    # x0 is reduced mod 2**32 only at the end (26 additions of words
    # below 2**32 stay below 2**37); x1 is reduced after every step, as
    # the rotation needs its 32 bits
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1)
            hi = x1 << r
            x1 = x1.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            x1.bitwise_xor_(x0).bitwise_and_(M32)
        x0.add_(ks[(i + 1) % 3])
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return x0.bitwise_and_(M32), x1


def _key_words(key):
    """(k0, k1) of a key [2], or columns [k, 1] of keys [k, 2] (uint32 or
    their int64 copy)."""
    k = key.to(torch.int64)
    return k[..., 0:1] if k.dim() == 2 else k[0], \
        k[..., 1:2] if k.dim() == 2 else k[1]


def _counters(n: int, device, base: int = 0):
    i = torch.arange(n, dtype=torch.int64, device=device) + base
    return i >> 32, i & M32


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def PRNGKey(seed: int, device) -> torch.Tensor:  # noqa: N802
    """The raw key of an integer seed on `device`: [seed >> 32, seed &
    0xFFFFFFFF] (a seed within int32, as the JAX package's seeds are,
    gives high word 0)."""
    seed = int(seed)
    hi = (seed >> 32) & M32 if not -2**31 <= seed < 2**31 else 0
    return torch.tensor([hi, seed & M32], dtype=torch.int64).to(
        torch.uint32).to(device)


def split_plain(key, n: int, base: int = 0):
    """[n, 2] subkeys of a key [2]; [F, n, 2] of a batch of keys [F, 2]."""
    k0, k1 = _key_words(key)
    c0, c1 = _counters(n, key.device, base)
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    return torch.stack([b0, b1], dim=-1).to(torch.uint32)


def random_bits_plain(key, shape):
    """32 random bits a position, as uint32 values held in int64: of
    `shape` for a key [2], of (F, *shape) for a batch of keys [F, 2]."""
    k0, k1 = _key_words(key)
    c0, c1 = _counters(_numel(shape), key.device)
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    return (b0 ^ b1).reshape(tuple(key.shape[:-1]) + tuple(shape))


def bits_to_unit(bits):
    """uint32 bits (in int64) -> float32 in [0, 1), as jax.random.uniform
    makes them."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_plain(key, shape):
    return bits_to_unit(random_bits_plain(key, shape))


def mean_rounds(mean: float, scale):
    """float32(mean) * scale, a float32 product as the JAX package's
    `draw_latency_rounds` takes it (`scale` a float32 tensor)."""
    return scale.to(torch.float32) * float(np.float32(mean))


def latency_from_unit(u, dist: str, mean):
    """Latency rounds from uniforms: round(u * 2 mean) for `uniform`,
    round(-log1p(-u) * mean) for `exponential`, rounding half to even
    as `jnp.round` does."""
    if dist == "uniform":
        x = u * (2.0 * mean)
    elif dist == "exponential":
        x = -torch.log1p(-u) * mean
    else:
        raise ValueError(f"no random draw for latency dist {dist!r}")
    return torch.round(x).to(torch.int32)


# --- wrappers: K7 on the card, the plain versions on the CPU ---------------

def _check_key(key, batched=False):
    """A key is uint32 [2]; where `batched`, a batch of keys [F, 2] is
    taken too."""
    ok = key.shape[-1:] == (2,) and key.dim() in ((1, 2) if batched
                                                    else (1,))
    if not ok or key.dtype != torch.uint32:
        raise ValueError(f"a key is uint32[2] (or a batch [F, 2] where "
                         f"taken), got {tuple(key.shape)} {key.dtype}")


def f32_bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", float(x)))[0]


def _launch(key, n, mode, out, base=0, p=None, scale=None, mean=0.0,
            dist="constant"):
    """One K7 launch of n draws a key: over a batch of keys [F, 2] the
    F * n elements go key by key, each key's from counter `base` (with
    [F] probabilities or scales, one a key)."""
    dev = key.device
    n_keys = key.shape[0] if key.dim() == 2 else 1
    K.THREEFRY.launch(
        [key.contiguous(), out, p, scale],
        [n * n_keys, base, mode, DISTS[dist], f32_bits(np.float32(mean)),
         n if key.dim() == 2 else 0], dev)
    return out


def split(key, n: int = 2, base: int = 0) -> torch.Tensor:
    """uint32 [n, 2]: the n subkeys of `key` (counters base .. base+n-1;
    base 0 is `jax.random.split`); [F, n, 2] for a batch of keys [F, 2]
    (`split` under `vmap`), in one launch."""
    _check_key(key, batched=True)
    if not K.use_kernel(key):
        return split_plain(key, n, base)
    out = torch.empty(tuple(key.shape[:-1]) + (n, 2), dtype=torch.uint32,
                      device=key.device)
    return _launch(key, n, SPLIT, out, base=base)


def fold_in(key, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a non-negative int data."""
    return split(key, 1, base=int(data) & M32)[0]


def random_bits(key, shape) -> torch.Tensor:
    """uint32 bits of `shape` (`jax.random.bits`); (F, *shape) for a
    batch of keys [F, 2]."""
    _check_key(key, batched=True)
    shape = tuple(shape)
    if not K.use_kernel(key):
        return random_bits_plain(key, shape).to(torch.uint32)
    out = torch.empty(tuple(key.shape[:-1]) + shape, dtype=torch.uint32,
                      device=key.device)
    return _launch(key, _numel(shape), BITS, out)


def _check_per_key(key, t, name):
    """A probability or scale: a scalar for one key, [F] for a batch of
    keys [F, 2]."""
    want = tuple(key.shape[:-1])
    if tuple(t.shape) != want or t.dtype != torch.float32:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{want} float32")


def uniform(key, shape) -> torch.Tensor:
    """float32 in [0, 1) of `shape` (`jax.random.uniform`)."""
    _check_key(key)
    shape = tuple(shape)
    if not K.use_kernel(key):
        return uniform_plain(key, shape)
    out = torch.empty(shape, dtype=torch.float32, device=key.device)
    return _launch(key, _numel(shape), UNIFORM, out)


def exponential(key, shape) -> torch.Tensor:
    """float32 of `shape`, -log1p(-uniform) (`jax.random.exponential`)."""
    return -torch.log1p(-uniform(key, shape))


def bernoulli_below(key, shape, p) -> torch.Tensor:
    """bool of `shape`: uniform(key, shape) < p, `p` a float32 scalar
    tensor on the key's device (the loss and duplication rolls); (F,
    *shape) for a batch of keys [F, 2] with p [F], one a key."""
    _check_key(key, batched=True)
    shape = tuple(shape)
    lead = tuple(key.shape[:-1])
    if not K.use_kernel(key):
        pc = p.reshape(lead + (1,) * len(shape))
        return bits_to_unit(random_bits_plain(key, shape)) < pc
    _check_per_key(key, p, "p")
    out = torch.empty(lead + shape, dtype=torch.bool, device=key.device)
    return _launch(key, _numel(shape), MASK, out, p=p.contiguous())


def draws(keys, n: int, specs):
    """The draws of several subkeys over n positions each: `specs[i]` is
    None (no draw), ("mask", p) for uniform < p, or ("latency", dist,
    mean, scale) for latency rounds, drawn from keys[i] of the uint32
    [k, 2] `keys`. Returns a list of flat [n] tensors (None where the
    spec is None). On the cluster axis `keys` is [F, k, 2] (one split a
    cluster), p and scale are [F], and each draw is [F, n], cluster f's
    from its own keys[f, i]. On the card each is one K7 launch; the
    plain version hashes every requested stream in one batched
    threefry."""
    rows = [i for i, sp in enumerate(specs) if sp is not None]
    out = [None] * len(specs)
    if not rows:
        return out
    fleet = keys.dim() == 3
    if K.use_kernel(keys):
        for i in rows:
            sp = specs[i]
            ki = keys[:, i].contiguous() if fleet else keys[i]
            if sp[0] == "mask":
                out[i] = bernoulli_below(ki, (n,), sp[1])
            else:
                out[i] = latency_rounds(ki, (n,), *sp[1:])
        return out
    # index after the int64 copy: torch's uint32 tensors take few ops
    kk = keys.to(torch.int64)[..., rows, :]
    k0, k1 = kk[..., 0:1], kk[..., 1:2]
    c0, c1 = _counters(n, keys.device)
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    u = bits_to_unit(b0 ^ b1)               # [(F,) len(rows), n]
    for j, i in enumerate(rows):
        sp = specs[i]
        uj = u[..., j, :]
        if sp[0] == "mask":
            out[i] = uj < (sp[1][:, None] if fleet else sp[1])
        else:
            mean = mean_rounds(sp[2], sp[3])
            out[i] = latency_from_unit(uj, sp[1],
                                       mean[:, None] if fleet else mean)
    return out


def latency_rounds(key, shape, dist: str, mean: float, scale):
    """int32 latency rounds of `shape` under a randomized distribution
    of mean `mean` rounds scaled by the float32 tensor `scale`
    (`net/tpu.py draw_latency_rounds` of the JAX package); (F, *shape)
    for a batch of keys [F, 2] with scale [F], one a key."""
    _check_key(key, batched=True)
    shape = tuple(shape)
    lead = tuple(key.shape[:-1])
    if not K.use_kernel(key):
        m = mean_rounds(mean, scale).reshape(lead + (1,) * len(shape))
        return latency_from_unit(bits_to_unit(random_bits_plain(key, shape)),
                                 dist, m)
    _check_per_key(key, scale, "scale")
    out = torch.empty(lead + shape, dtype=torch.int32, device=key.device)
    return _launch(key, _numel(shape), LATENCY, out,
                   scale=scale.contiguous(), mean=mean, dist=dist)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 in [minval, maxval) of `shape` (`jax.random.randint` with
    the default int32 dtype and int32-range bounds); (F, *shape) for a
    batch of keys [F, 2]."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape).to(torch.int64)
    lo = random_bits(keys[..., 1, :], shape).to(torch.int64)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((hi % span) * mult) & M32) + lo % span) & M32
    off = off % span
    out = (off + minval) & M32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
