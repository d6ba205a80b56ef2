"""The scenes a configuration's ``scene`` key names, one module each:
``build_program(config, seed, device)`` builds the port's scene and
``build_reference(config, seed, device)`` the reference's description of
the same scene, each from the configuration's file and the seed alone."""

import importlib


def get(name: str):
    return importlib.import_module(f"benchmark.scenes.{name}")
