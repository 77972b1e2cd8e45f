"""raytracingrenderer_tpu — a differentiable path tracer in JAX.

A from-scratch JAX framework with the capabilities of the reference
RTBase renderer: .gem/scene.json scene loading, SAH BVH ray-scene
intersection (a CUDA traversal kernel on NVIDIA GPUs), the full BSDF set,
area/environment lights with MIS, and four integrators (path tracing
with NEE, light tracing, instant radiosity, adaptive sampling) —
designed wavefront-style over sharded ray batches on a device mesh,
differentiable end-to-end.
"""

__version__ = "0.1.0"
