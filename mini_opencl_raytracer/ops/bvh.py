"""LBVH: on-device linear BVH build (Morton sort) + batched traversal.

Re-design of the reference's CPU-recursive SAH builder
(CLBVHScene::RecursiveBuild / FlattenBVHTree, CLBVHnode.cpp:7-207) and its
per-thread stack traversal (Intersect, kernel_bvh.cl:171-219).

Build: triangles are sorted along a 30-bit Morton curve of their
quantized centroids (``jax.lax.sort_key_val`` — the whole build is sorts,
reshapes and reductions, so it runs on device with static shapes); sorted
triangles are grouped into fixed-size leaves and a *complete binary tree*
of AABBs is built bottom-up over the leaves (a segment-tree LBVH). Unlike
the reference's pointer-flattening pass (CLBVHnode.cpp:161-183), the heap
layout is implicit: node ``i`` has children ``2i+1`` / ``2i+2`` and leaves
occupy the last level — no offsets stored at all.

Fixed-size leaves replace maxPrimitivesInNode=4 (CLEngineBase.cpp:175):
leaf intersection is a dense [leaf_size] panel per ray, with leaves
larger than the reference's (default 8, ``BVHConfig.leaf_size``).

Traversal is a vmapped while-loop with an explicit small stack,
mirroring the reference's nodesToVisit[64] (kernel_bvh.cl:180-181),
including its near-child-first ordering (kernel_bvh.cl:199-208 — ours
orders by actual child entry distance instead of the stored split
axis). It is the intersector ``auto`` picks for large scenes. Under
vmap every lane iterates until the deepest ray finishes, and each
iteration is a handful of small kernels, so on a GPU the walk is bound
by launches and by its longest ray (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import pytree
from ..config import BVHConfig
from ..models.scene import Geometry
from .intersect import Hit, ray_triangle

_BIG = 1e30


def expand_bits_10(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of each uint32 lane with two zero bits
    between them (standard Morton bit-dilation)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(points01: jax.Array) -> jax.Array:
    """[N, 3] points in [0,1] -> 30-bit Morton codes (uint32)."""
    q = jnp.clip(points01 * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (expand_bits_10(q[:, 0]) * 4
            + expand_bits_10(q[:, 1]) * 2
            + expand_bits_10(q[:, 2]))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@pytree.dataclass
class BVH:
    """Segment-tree LBVH over Morton-sorted triangles.

    Heap layout: ``2 * num_leaves - 1`` nodes, root at 0, children of ``i``
    at ``2i+1`` / ``2i+2``; leaf ``j`` is node ``num_leaves - 1 + j`` and
    covers triangle slots ``[j*leaf_size, (j+1)*leaf_size)`` of the padded,
    Morton-ordered buffers. Padding slots hold degenerate far-away
    triangles that can never win an intersection.
    """

    node_lo: jax.Array      # [2L-1, 3]
    node_hi: jax.Array      # [2L-1, 3]
    pv0: jax.Array          # [L*leaf, 3] morton-ordered, padded corners
    pv1: jax.Array          # [L*leaf, 3]
    pv2: jax.Array          # [L*leaf, 3]
    slot_to_tri: jax.Array  # [L*leaf] int32 original triangle index
    leaf_size: int = pytree.field(static=True)
    num_leaves: int = pytree.field(static=True)

    @property
    def depth(self) -> int:
        """Tree depth (root = level 0)."""
        return self.num_leaves.bit_length() - 1

    @property
    def num_nodes(self) -> int:
        return 2 * self.num_leaves - 1


def build_bvh(geometry: Geometry, cfg: BVHConfig = BVHConfig()) -> BVH:
    """Build the LBVH. Pure JAX (jit-able per triangle count)."""
    v0 = jax.lax.stop_gradient(geometry.v0)
    v1 = jax.lax.stop_gradient(geometry.v1)
    v2 = jax.lax.stop_gradient(geometry.v2)
    T = v0.shape[0]
    leaf = cfg.leaf_size

    # Morton order of quantized centroids over the scene bounds
    # (replaces the SAH split search, CLBVHnode.cpp:76-134).
    cent = (v0 + v1 + v2) / 3.0
    lo = jnp.min(cent, axis=0)
    hi = jnp.max(cent, axis=0)
    extent = jnp.maximum(hi - lo, 1e-12)
    codes = morton3d((cent - lo) / extent)
    _, order = jax.lax.sort_key_val(codes, jnp.arange(T, dtype=jnp.int32))

    # Pad to a full power-of-two leaf grid.
    L = _next_pow2(max((T + leaf - 1) // leaf, 1))
    S = L * leaf
    pad = S - T
    slot_to_tri = jnp.pad(order, (0, pad))

    def padded(a):
        a = jnp.take(a, order, axis=0)
        return jnp.pad(a, ((0, pad), (0, 0)), constant_values=_BIG)

    pv0, pv1, pv2 = padded(v0), padded(v1), padded(v2)

    # Leaf AABBs by dense segment reduction (replaces per-node bound
    # accumulation, CLBVHnode.cpp:19-23).
    tri_lo = jnp.minimum(jnp.minimum(pv0, pv1), pv2).reshape(L, leaf, 3)
    tri_hi = jnp.maximum(jnp.maximum(pv0, pv1), pv2).reshape(L, leaf, 3)
    # Padding slots: make them an empty box that fails every slab test.
    pad_mask = (jnp.arange(S) >= T).reshape(L, leaf, 1)
    tri_lo = jnp.where(pad_mask, _BIG, tri_lo)
    tri_hi = jnp.where(pad_mask, -_BIG, tri_hi)
    leaf_lo = jnp.min(tri_lo, axis=1)
    leaf_hi = jnp.max(tri_hi, axis=1)

    # Bottom-up union sweep: level k has 2^k nodes (static Python loop
    # over log2(L) levels -> pure reshape/min/max ops).
    levels_lo = [leaf_lo]
    levels_hi = [leaf_hi]
    cur_lo, cur_hi = leaf_lo, leaf_hi
    while cur_lo.shape[0] > 1:
        cur_lo = jnp.minimum(cur_lo[0::2], cur_lo[1::2])
        cur_hi = jnp.maximum(cur_hi[0::2], cur_hi[1::2])
        levels_lo.append(cur_lo)
        levels_hi.append(cur_hi)
    node_lo = jnp.concatenate(levels_lo[::-1], axis=0)
    node_hi = jnp.concatenate(levels_hi[::-1], axis=0)

    return BVH(node_lo=node_lo, node_hi=node_hi,
               pv0=pv0, pv1=pv1, pv2=pv2,
               slot_to_tri=slot_to_tri.astype(jnp.int32),
               leaf_size=leaf, num_leaves=L)


def _slab_test(lo, hi, o, inv_d, t_best):
    """Ray-AABB slab test with current-best early bound (RayBounds,
    kernel_bvh.cl:156-169), sign handling via min/max instead of the
    reference's precomputed sign[] indexing."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2))
    tmax = jnp.min(jnp.maximum(t1, t2))
    t0 = jnp.maximum(tmin, 0.0)
    t1b = jnp.minimum(tmax, t_best)
    return t1b >= t0, tmin


def _intersect_one(o, d, t_init, bvh: BVH, backface_cull: bool):
    """Closest hit for a single ray (vmapped). Returns (t, slot, hit)."""
    L = bvh.num_leaves
    leaf = bvh.leaf_size
    max_stack = bvh.depth + 2
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)

    def leaf_hit(leaf_id, best_t, best_slot):
        base = leaf_id * leaf
        rows = base + jnp.arange(leaf)
        lv0 = jnp.take(bvh.pv0, rows, axis=0)
        lv1 = jnp.take(bvh.pv1, rows, axis=0)
        lv2 = jnp.take(bvh.pv2, rows, axis=0)
        t, _, _, valid = ray_triangle(o[None, :], d[None, :], lv0, lv1, lv2,
                                      backface_cull=backface_cull)
        t = jnp.where(valid & (t < best_t), t, jnp.inf)
        k = jnp.argmin(t)
        better = t[k] < best_t
        return (jnp.where(better, t[k], best_t),
                jnp.where(better, base + k.astype(jnp.int32), best_slot))

    def body(state):
        stack, sp, best_t, best_slot = state
        sp = sp - 1
        node = stack[sp]
        in_box, _ = _slab_test(bvh.node_lo[node], bvh.node_hi[node],
                               o, inv_d, best_t)
        is_leaf = node >= (L - 1)

        # Leaf: dense panel intersection over its triangle block.
        best_t, best_slot = jax.lax.cond(
            in_box & is_leaf,
            lambda: leaf_hit(node - (L - 1), best_t, best_slot),
            lambda: (best_t, best_slot))

        # Interior: push children, near-first (reference orders by split
        # axis sign, kernel_bvh.cl:199-208; we order by entry distance).
        def push_children(stack, sp):
            c0 = 2 * node + 1
            c1 = 2 * node + 2
            _, tn0 = _slab_test(bvh.node_lo[c0], bvh.node_hi[c0], o, inv_d,
                                best_t)
            _, tn1 = _slab_test(bvh.node_lo[c1], bvh.node_hi[c1], o, inv_d,
                                best_t)
            near_first = tn0 <= tn1
            first = jnp.where(near_first, c0, c1)
            second = jnp.where(near_first, c1, c0)
            stack = stack.at[sp].set(second)
            stack = stack.at[sp + 1].set(first)
            return stack, sp + 2

        stack, sp = jax.lax.cond(
            in_box & ~is_leaf,
            push_children,
            lambda stack, sp: (stack, sp),
            stack, sp)
        return stack, sp, best_t, best_slot

    def cond(state):
        _, sp, _, _ = state
        return sp > 0

    stack0 = jnp.zeros((max_stack,), jnp.int32)
    state = (stack0, jnp.int32(1), t_init, jnp.int32(0))
    _, _, best_t, best_slot = jax.lax.while_loop(cond, body, state)
    return best_t, best_slot, best_t < t_init


def intersect_bvh(o: jax.Array, d: jax.Array, bvh: BVH,
                  t_max: float = 1e5, backface_cull: bool = False) -> Hit:
    """Batched closest hit via the LBVH -> Hit with *original* triangle
    indices (the Morton permutation is unwound through slot_to_tri, the
    analog of the reference's leaf-contiguous orderedTriangles,
    CLBVHnode.cpp:196-197)."""
    t_init = jnp.full((o.shape[0],), t_max, o.dtype)
    f = functools.partial(_intersect_one, bvh=bvh,
                          backface_cull=backface_cull)
    best_t, best_slot, hit = jax.vmap(f)(o, d, t_init)
    tri_idx = jnp.take(bvh.slot_to_tri, best_slot)
    return Hit(t=jnp.where(hit, best_t, t_max),
               tri_idx=jnp.where(hit, tri_idx, 0),
               hit=hit)


def occluded_bvh(o: jax.Array, d: jax.Array, t_limit: jax.Array, bvh: BVH,
                 backface_cull: bool = False) -> jax.Array:
    """Shadow-ray occlusion query: any hit with 0 < t < t_limit."""
    finite_limit = jnp.where(jnp.isfinite(t_limit), t_limit, _BIG)
    f = functools.partial(_intersect_one, bvh=bvh,
                          backface_cull=backface_cull)
    best_t, _, hit = jax.vmap(f)(o, d, finite_limit)
    return hit
