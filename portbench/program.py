"""The system under test, as a user of the PyTorch port builds it: a model
of the port's registry at the configuration's widths on the card, the
weights the benchmark drew loaded with ``load_state_dict``, and the eval
runner or the training step of the port's own API. Every other module of
the benchmark reaches the port through here."""

import torch

from portbench.reference import model as reference
from portbench.weights import draw_state

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parameter_shapes(config: dict):
    """(name, shape) of every parameter of the configuration's model, read
    from the plain reference built on the meta device."""
    model = reference.build(config, device="meta")
    return [(name, tuple(p.shape)) for name, p in model.named_parameters()]


def weights(config: dict, seed: int, device) -> dict:
    """The state dict of the run: drawn on ``device`` from ``seed``, then the
    configuration's ``weight_overrides`` (an entry of every parameter whose
    name has the prefix and suffix set to the value)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    state = draw_state(parameter_shapes(config), generator, device)
    for rule in config.get("weight_overrides", []):
        for name, tensor in state.items():
            if name.startswith(rule["prefix"]) and name.endswith(rule["suffix"]):
                tensor[rule["index"]] = rule["value"]
    return state


def build_model(config: dict, state: dict, device):
    """The port's model (``Model_Dict[config["model"]]``) in the configured
    compute dtype, built on ``device``, loaded with ``state``. The
    configuration's ``program_kwargs`` (build flags that choose an
    implementation, not the function) go to the port alone."""
    from lintransunet_tpu_torch.models import Model_Dict

    flags = config.get("program_kwargs", {})
    both = sorted(flags.keys() & config["model_kwargs"].keys())
    if both:
        raise ValueError(f"configuration {config['name']!r}: {both} in both model_kwargs "
                         "and program_kwargs")
    cls = Model_Dict[config["model"]]
    with torch.device(device):
        model = cls(**config["model_kwargs"], **flags,
                    dtype=COMPUTE_DTYPES[config["compute_dtype"]], device=device)
    model.load_state_dict(state)
    return model


def eval_runner(model, traffic: dict):
    """The inference CLI's runner: ``make_eval_runner`` with a square window
    of the mix, its overlap and blend, ``sw_batch_size`` windows a forward."""
    from lintransunet_tpu_torch.cli.common import EvalConfig, make_eval_runner

    h, _, d = traffic["window"]
    cfg = EvalConfig(roi_size=h, depth_size=d, overlap=traffic["overlap"], mode=traffic["blend"])
    return make_eval_runner(model, cfg, sw_batch_size=traffic["sw_batch"])[1]


def to_device(volume, device):
    from lintransunet_tpu_torch.engine.loop import to_device as port_to_device

    return port_to_device(volume, device)


def train_step(model, traffic: dict, mesh=None):
    """(state, step) of the port's training API at the mix's recipe."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import get_criterion_list

    criterions, _ = get_criterion_list(len(traffic["level_weights"]), tuple(traffic["criteria"]))
    state = engine.create_train_state(model, learning_rate=traffic["learning_rate"],
                                      step_times=traffic["step_times"])
    return state, engine.make_train_step(model, criterions, mesh=mesh)


def make_mesh(world: int, device):
    from lintransunet_tpu_torch import parallel

    return parallel.make_mesh(world, device=device)


def replicate(mesh, model):
    from lintransunet_tpu_torch import parallel

    return parallel.replicate(mesh, model)


def save_params(path: str, state: dict) -> None:
    """``state`` as the port's training CLI leaves its best parameters
    (``engine.save_params``, the ``temp_model`` the inference CLI loads)."""
    import os

    from lintransunet_tpu_torch import engine

    os.makedirs(os.path.dirname(path), exist_ok=True)
    engine.save_params(path, state)


# the configuration's model keys as the inference CLI's flags
CLI_MODEL_FLAGS = {"num_layers": "--num_layers", "roi_size_list": "--roi_size_list",
                   "is_roi_list": "--is_roi_list", "dim_input": "--dim_input",
                   "dim_output": "--dim_output", "n_layers": "--attn_layers"}


def cli_args(config: dict, traffic: dict, paths: dict, device):
    """The inference CLI's arguments, parsed by its own parser
    (``inference_embed_attn.get_parse``): the configuration's model, the
    mix's window, overlap, windows a forward and threshold, and ``paths``
    (``dir_data``, ``pretrained_dir``, ``split_json``, ``saved_folder``),
    with the export on."""
    import sys

    from lintransunet_tpu_torch.cli import inference_embed_attn as cli

    if config.get("program_kwargs"):
        raise ValueError(f"configuration {config['name']!r}: the inference CLI has no flag "
                         f"for the build flags {sorted(config['program_kwargs'])}")
    flags = ["--model_name", config["model"], "--compute_dtype", config["compute_dtype"],
             "--device", str(device), "--is_save", "true"]
    for key, value in config["model_kwargs"].items():
        if key == "dropout":  # the CLI has no flag for it, and eval draws none
            continue
        if key not in CLI_MODEL_FLAGS:
            raise ValueError(f"configuration {config['name']!r}: the inference CLI has no "
                             f"flag for {key!r}")
        joined = ",".join(str(v).lower() for v in value) if isinstance(value, list) else value
        flags += [CLI_MODEL_FLAGS[key], str(joined)]
    h, _, d = traffic["window"]
    flags += ["--roi_size", str(h), "--depth_size", str(d), "--overlap", str(traffic["overlap"]),
              "--sw_batch_size", str(traffic["sw_batch"]), "--threshold", str(traffic["threshold"])]
    for key, path in paths.items():
        flags += [f"--{key}", path]
    argv = sys.argv
    sys.argv = ["inference_embed_attn", *flags]
    try:
        return cli.get_parse()
    finally:
        sys.argv = argv


def serve_folder(args) -> None:
    """One run of the port's inference CLI over its test folder:
    ``inference_embed_attn.main(args)``, looked up at each call."""
    from lintransunet_tpu_torch.cli import inference_embed_attn as cli

    cli.main(args)
