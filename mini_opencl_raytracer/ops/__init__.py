"""Compute ops: RNG, ray generation, intersection, BVH, BRDF, lighting,
and the path-trace integrator."""
