"""The bench scene: the port's ``build_bench_scene`` and the reference's
frozen copy of it, at the configuration's size and triangle budget."""


def build_program(config: dict, seed: int, device):
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene

    return build_bench_scene(config["width"], config["height"],
                             config["target_tris"], device=device)


def build_reference(config: dict, seed: int, device):
    from benchmark.reference.bench_scene import build_bench_scene

    return build_bench_scene(config["width"], config["height"],
                             config["target_tris"], device=device)
