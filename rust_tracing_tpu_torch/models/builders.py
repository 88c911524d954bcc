"""The nine canonical scenes (reference: src/main.rs:56-639).

Each builder returns ``(SceneBuilder, RenderSettings)``. Random scene content
(random_balls, final_scene) uses a *seeded* numpy generator — the reference
uses OS-seeded thread RNG, so its geometry differs run to run; fixed seeds
make ours reproducible (SURVEY.md §7 RNG parity).

The earth image texture loads from ``RT_EARTH_ASSET`` or ``assets/`` if
readable, else a procedural fallback keeps the scene runnable anywhere.

Host-side numpy; the port's own copy of rust_tracing_tpu/models/builders.py.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..config import RenderSettings
from ..utils.image_io import read_image_rgb8
from .scene import SceneBuilder, Transform

SKY = (0.7, 0.8, 1.0)
BLACK = (0.0, 0.0, 0.0)

EARTH_ASSET_CANDIDATES = (
    os.environ.get("RT_EARTH_ASSET", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "earth-large.jpg"),
)


def _earth_image() -> np.ndarray:
    for path in EARTH_ASSET_CANDIDATES:
        if path and os.path.exists(path):
            return read_image_rgb8(path)
    # Procedural fallback: blue-green latitude bands so the scene still runs.
    h, w = 512, 1024
    v = np.linspace(0, 1, h)[:, None] * np.ones((1, w))
    u = np.ones((h, 1)) * np.linspace(0, 1, w)[None, :]
    land = (np.sin(u * 21.0) * np.sin(v * 13.0)) > 0.2
    img = np.where(land[..., None],
                   np.array([60, 160, 70], np.uint8),
                   np.array([30, 60, 180], np.uint8)).astype(np.uint8)
    return img


def random_balls(seed: int = 0) -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:56-138."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=SKY)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                color = rng.random(3) * rng.random(3)
                target = center + np.array([0.0, rng.random() * 0.5, 0.0])
                b.add_sphere(center, 0.2, b.lambertian(tuple(color)), target=target)
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                b.add_sphere(center, 0.2, b.metal(tuple(albedo), fuzz))
            else:
                b.add_sphere(center, 0.2, b.dielectric(1.5))

    b.add_sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.add_sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    settings = RenderSettings(
        aspect_ratio=16.0 / 9.0, image_width=600, samples_per_pixel=128,
        max_depth=8, background=SKY, vfov=20.0, look_from=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    return b, settings


def two_spheres() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:140-173."""
    b = SceneBuilder(background=SKY)
    checker = b.lambertian(b.checker_texture(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.add_sphere((0.0, -10.0, 0.0), 10.0, checker)
    b.add_sphere((0.0, 10.0, 0.0), 10.0, checker)
    settings = RenderSettings(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=128,
        max_depth=8, background=SKY, vfov=20.0, look_from=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
    )
    return b, settings


def earth() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:175-203."""
    b = SceneBuilder(background=SKY)
    b.add_sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(b.image_texture(_earth_image())))
    settings = RenderSettings(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=128,
        max_depth=8, background=SKY, vfov=20.0, look_from=(12.0, 0.0, 0.0),
        look_at=(0.0, 0.0, 0.0),
    )
    return b, settings


def two_perlin_spheres() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:205-237."""
    b = SceneBuilder(background=SKY)
    noise = b.lambertian(b.noise_texture(4.0))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, noise)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, noise)
    settings = RenderSettings(
        aspect_ratio=16.0 / 9.0, image_width=1200, samples_per_pixel=128,
        max_depth=8, background=SKY, vfov=20.0, look_from=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
    )
    return b, settings


def quads() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:239-294."""
    b = SceneBuilder(background=SKY)
    b.add_quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), b.lambertian((1.0, 0.2, 0.2)))
    b.add_quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), b.lambertian((0.2, 1.0, 0.2)))
    b.add_quad((3, -2, 1), (0, 0, 4), (0, 4, 0), b.lambertian((0.2, 0.2, 1.0)))
    b.add_quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), b.lambertian((1.0, 0.5, 0.0)))
    b.add_quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), b.lambertian((0.2, 0.8, 0.8)))
    settings = RenderSettings(
        aspect_ratio=1.0, image_width=1200, samples_per_pixel=128, max_depth=8,
        background=SKY, vfov=80.0, look_from=(0.0, 0.0, 9.0), look_at=(0.0, 0.0, 0.0),
    )
    return b, settings


def simple_light() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:296-342."""
    b = SceneBuilder(background=BLACK)
    noise_tex = b.noise_texture(4.0)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise_tex))
    b.add_sphere((0.0, 2.0, 0.0), 2.0, b.lambertian(noise_tex))
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.add_quad((3.0, 1.0, -2.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), light)
    b.add_sphere((0.0, 7.0, 0.0), 2.0, light)
    settings = RenderSettings(
        aspect_ratio=16.0 / 9.0, image_width=600, samples_per_pixel=1024,
        max_depth=8, background=BLACK, vfov=20.0, look_from=(26.0, 3.0, 6.0),
        look_at=(0.0, 2.0, 0.0),
    )
    return b, settings


def _cornell_walls(b: SceneBuilder, light_rgb, light_q, light_u, light_v) -> None:
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light(light_rgb)
    b.add_quad((555, 0, 555), (0, 555, 0), (0, 0, -555), green)
    b.add_quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.add_quad(light_q, light_u, light_v, light)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white)
    return white


_CORNELL_SETTINGS = dict(
    aspect_ratio=1.0, image_width=600, samples_per_pixel=4096, max_depth=8,
    background=BLACK, vfov=40.0, look_from=(278.0, 278.0, -800.0),
    look_at=(278.0, 278.0, 0.0),
)


def cornell_box() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:344-421."""
    b = SceneBuilder(background=BLACK)
    white = _cornell_walls(b, (15.0, 15.0, 15.0),
                           (343, 554, 332), (-130, 0, 0), (0, 0, -105))
    b.add_cube((0, 0, 0), (165, 330, 165), white,
               Transform(rotate_y_deg=15.0, translate=(265.0, 0.0, 295.0)))
    b.add_cube((0, 0, 0), (165, 165, 165), white,
               Transform(rotate_y_deg=-18.0, translate=(130.0, 0.0, 65.0)))
    return b, RenderSettings(**_CORNELL_SETTINGS)


def cornell_smoke() -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:423-506."""
    b = SceneBuilder(background=BLACK)
    _cornell_walls(b, (7.0, 7.0, 7.0), (113, 554, 127), (330, 0, 0), (0, 0, 305))
    b.add_box_medium((0, 0, 0), (165, 330, 165), 0.01, (0.0, 0.0, 0.0),
                     Transform(rotate_y_deg=15.0, translate=(265.0, 0.0, 295.0)))
    b.add_box_medium((0, 0, 0), (165, 165, 165), 0.01, (1.0, 1.0, 1.0),
                     Transform(rotate_y_deg=-18.0, translate=(130.0, 0.0, 65.0)))
    return b, RenderSettings(**_CORNELL_SETTINGS)


def final_scene(seed: int = 0) -> Tuple[SceneBuilder, RenderSettings]:
    """reference: src/main.rs:508-639."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=BLACK)

    # Green ground boxes (main.rs:515-533)
    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            side = 100.0
            x0, z0 = -1000.0 + i * side, -1000.0 + j * side
            y1 = rng.uniform(1.0, 101.0)
            b.add_cube((x0, 0.0, z0), (x0 + side, y1, z0 + side), ground)

    # Light (main.rs:536-541)
    b.add_quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
               b.diffuse_light((7.0, 7.0, 7.0)))

    # Motion-blurred sphere (main.rs:543-549)
    b.add_sphere((400, 400, 200), 50.0, b.lambertian((0.7, 0.3, 0.1)),
                 target=(430, 400, 200))
    # Glass + fuzzy metal (main.rs:551-562)
    b.add_sphere((260, 150, 45), 50.0, b.dielectric(1.5))
    b.add_sphere((0, 150, 145), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))

    # Subsurface: glass shell + interior medium (main.rs:564-575)
    b.add_sphere((360, 150, 145), 70.0, b.dielectric(1.5))
    b.add_sphere_medium((360, 150, 145), 70.0, 0.2, (0.2, 0.4, 0.9))

    # Global fog (main.rs:577-587)
    b.add_sphere_medium((0, 0, 0), 5000.0, 0.0001, (1.0, 1.0, 1.0))

    # Earth + noise spheres (main.rs:589-605)
    b.add_sphere((400, 200, 400), 100.0, b.lambertian(b.image_texture(_earth_image())))
    b.add_sphere((220, 280, 300), 80.0, b.lambertian(b.noise_texture(0.1)))

    # 1000-sphere box, rotated + translated (main.rs:607-622)
    white = b.lambertian((0.73, 0.73, 0.73))
    xform = Transform(rotate_y_deg=15.0, translate=(-100.0, 270.0, 395.0))
    for _ in range(1000):
        b.add_sphere(tuple(rng.uniform(0.0, 165.0, 3)), 10.0, white,
                     transform=xform)

    settings = RenderSettings(
        aspect_ratio=1.0, image_width=800, samples_per_pixel=8192, max_depth=40,
        background=BLACK, vfov=40.0, look_from=(478.0, 278.0, -600.0),
        look_at=(278.0, 278.0, 0.0),
    )
    return b, settings


SCENES = {
    0: random_balls,
    1: two_spheres,
    2: earth,
    3: two_perlin_spheres,
    4: quads,
    5: simple_light,
    6: cornell_box,
    7: cornell_smoke,
    8: final_scene,
}

SCENE_NAMES = {
    0: "random_balls",
    1: "two_spheres",
    2: "earth",
    3: "two_perlin_spheres",
    4: "quads",
    5: "simple_light",
    6: "cornell_box",
    7: "cornell_smoke",
    8: "final_scene",
}


def build_scene(index: int, seed: int = 0):
    """Scene dispatch (reference: src/main.rs:645-656).

    Unlike the reference's silent default arm, an unknown index is an error —
    a typoed ``--scene 9`` should not burn a long render on the wrong scene.
    """
    if index not in SCENES:
        valid = ", ".join(f"{i}:{SCENE_NAMES[i]}" for i in sorted(SCENES))
        raise ValueError(f"unknown scene index {index}; valid: {valid}")
    fn = SCENES[index]
    try:
        return fn(seed=seed)  # type: ignore[call-arg]
    except TypeError:
        return fn()
