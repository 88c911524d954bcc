"""The reference's final scene of "The Next Week" (main.rs scene 8): a
ground of random boxes, a light, a moving sphere, glass, metal, two media,
the earth's image, a noise sphere and a box of 1000 spheres. Its random
boxes and spheres are drawn from numpy's generator at the configuration's
``geometry_seed``."""

import numpy as np

from port_bench.reference.scenes import (DIELECTRIC, LAMBERTIAN, METAL,
                                         TEX_IMAGE, TEX_NOISE, Scene,
                                         Transform)


def earth_bands() -> np.ndarray:
    """The earth texture's stand-in: blue and green bands, 1024x512, as
    linear colour (gamma 2.2 of the 8-bit values)."""
    h, w = 512, 1024
    v = np.linspace(0, 1, h)[:, None] * np.ones((1, w))
    u = np.ones((h, 1)) * np.linspace(0, 1, w)[None, :]
    land = (np.sin(u * 21.0) * np.sin(v * 13.0)) > 0.2
    rgb8 = np.where(land[..., None], np.array([60, 160, 70], np.uint8),
                    np.array([30, 60, 180], np.uint8)).astype(np.uint8)
    return ((np.asarray(rgb8, np.float64) / 255.0) ** 2.2).astype(np.float32)


def build(cfg) -> Scene:
    rng = np.random.default_rng(cfg["geometry_seed"])
    s = Scene(cfg["background"])
    ground = s.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            x0, z0 = -1000.0 + i * 100.0, -1000.0 + j * 100.0
            y1 = rng.uniform(1.0, 101.0)
            s.box((x0, 0.0, z0), (x0 + 100.0, y1, z0 + 100.0), ground)
    s.quad((123, 554, 147), (300, 0, 0), (0, 0, 265), s.light((7.0, 7.0, 7.0)))
    s.sphere((400, 400, 200), 50.0, s.lambertian((0.7, 0.3, 0.1)),
             target=(430, 400, 200))
    s.sphere((260, 150, 45), 50.0, s.material(DIELECTRIC, ir=1.5))
    s.sphere((0, 150, 145), 50.0,
             s.material(METAL, albedo=(0.8, 0.8, 0.9), fuzz=1.0))
    s.sphere((360, 150, 145), 70.0, s.material(DIELECTRIC, ir=1.5))
    s.sphere_medium((360, 150, 145), 70.0, 0.2, (0.2, 0.4, 0.9))
    s.sphere_medium((0, 0, 0), 5000.0, 0.0001, (1.0, 1.0, 1.0))
    s.image = earth_bands()
    s.texture(TEX_IMAGE)
    s.sphere((400, 200, 400), 100.0, s.material(LAMBERTIAN, len(s.tex) - 1))
    s.sphere((220, 280, 300), 80.0,
             s.lambertian(s.texture(TEX_NOISE, noise_scale=0.1)))
    white = s.lambertian((0.73, 0.73, 0.73))
    xf = Transform(15.0, (-100.0, 270.0, 395.0))
    for _ in range(1000):
        s.sphere(tuple(rng.uniform(0.0, 165.0, 3)), 10.0, white, xf=xf)
    return s
