"""The reference's Cornell box of "The Next Week" (main.rs scene 6), built
from the book's constructions: five walls, a light, two rotated boxes."""

from port_bench.reference.scenes import Scene, Transform


def build(cfg) -> Scene:
    s = Scene(cfg["background"])
    red = s.lambertian((0.65, 0.05, 0.05))
    white = s.lambertian((0.73, 0.73, 0.73))
    green = s.lambertian((0.12, 0.45, 0.15))
    light = s.light((15.0, 15.0, 15.0))
    s.quad((555, 0, 555), (0, 555, 0), (0, 0, -555), green)
    s.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    s.quad((343, 554, 332), (-130, 0, 0), (0, 0, -105), light)
    s.quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    s.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    s.quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white)
    s.box((0, 0, 0), (165, 330, 165), white,
          Transform(15.0, (265.0, 0.0, 295.0)))
    s.box((0, 0, 0), (165, 165, 165), white,
          Transform(-18.0, (130.0, 0.0, 65.0)))
    return s
