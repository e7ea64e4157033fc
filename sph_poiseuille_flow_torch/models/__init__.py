from .poiseuille import Scene, build_scene, fluid_lattice, build_wall_particles

__all__ = ["Scene", "build_scene", "fluid_lattice", "build_wall_particles"]
