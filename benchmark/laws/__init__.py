"""Read-length laws: ``laws/<law>.py`` gives ``draw(params, rng)``."""
