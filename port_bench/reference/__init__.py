"""Plain PyTorch reference of the path tracer, independent of the port.

A frozen copy of the estimator the port computes: the counter RNG addressed
by (seed, pixel, sample, bounce, site), the camera, the scenes of
``main.rs`` built from their parameters, the brute-force closest hit over
every primitive, constant media, the five materials, the solid, noise and
image textures of the fused render, and the differentiable record/replay
gradient of a scene of quads. It imports no module of the port and reads
nothing the port made: it builds its scene tables itself. Every function
takes the float type it computes in, so the same code in bfloat16 is the
control that the comparison has to fail.
"""
