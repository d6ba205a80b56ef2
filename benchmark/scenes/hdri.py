"""The bench scene lit by a seeded equirect map, with a directional and an
area light: the port's ``build_hdri_scene`` and the reference's frozen
copy of it, the map made from ``seed`` at the configuration's size."""


def build_program(config: dict, seed: int, device):
    from ptrt_tpu_torch.app.bench_scene import build_hdri_scene

    return build_hdri_scene(config["width"], config["height"],
                            config["target_tris"], device=device,
                            env_hw=tuple(config["env_hw"]), seed=seed)


def build_reference(config: dict, seed: int, device):
    from benchmark.reference.bench_scene import build_hdri_scene

    return build_hdri_scene(config["width"], config["height"],
                            config["target_tris"], device=device,
                            env_hw=tuple(config["env_hw"]), seed=seed)
