"""The port's API against the JAX package's, module by module: for every
``gspn_tpu/<path>.py`` (but the TPU-only modules) each public function and
class defined there (by ``__module__``), and each public method such a
class defines, has a namesake in ``gspn_tpu_torch/<path>.py``; every
parameter of the JAX signature is a parameter of the port's, with the
same default where both are plain literals; or it stands in the tables
below with the reason it is spelled, set or carried otherwise. A
parameter added to a JAX function, or a function added to a JAX module,
without its port counterpart fails here; so does a table entry that no
longer applies. One case a module and check."""

import importlib
import inspect
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# TPU-only modules the port leaves out (ROADMAP.md, "Do not carry"): none
# since utils/debug.py, roofline.py and timing.py were ported
TPU_ONLY: dict[str, str] = {}

# A JAX parameter of this name, in any function, stands for what the port
# takes instead; the second item lists the port's names (any of them may
# be the port's parameter, or none where the port holds it elsewhere).
RENAMED_EVERYWHERE = {
    "parent": ((), "Flax's module tree: a torch module holds its submodules"),
    "name": ((), "Flax's scope name: the port names submodules by attribute, as "
                 "convert.py maps them"),
    "interpret": ((), "Pallas's interpret mode: a CUDA kernel has none; on the CPU an op runs "
                      "its plain version"),
    "extract": ((), "the Pallas kernels' extraction schedule: one CUDA kernel a selection"),
    "rng": (("generator",), "a JAX PRNG key: the port takes its draws or a torch.Generator"),
    "key": (("generator",), "a JAX PRNG key: the port takes a torch.Generator"),
    "axis_name": (("group",), "a mesh axis: the port's collectives take a process group"),
    "bn_axis": ((), "a mesh axis for BatchNorm statistics: nn.layers.cross_rank_statistics "
                    "sets a process group on the model's BatchNorms"),
    "dp_axis": (("dp_group",), "a mesh axis: the DP losses take a process group"),
    "axis": (("mesh",), "a mesh axis: the port's mesh (DataMesh, PointMesh) holds its groups"),
    "data_axis": (("mesh",), "a mesh axis: PointMesh holds the data rows' group"),
    "space_axis": (("n_space",), "a mesh axis: PointMesh holds the row's group"),
    "tx": (("lr_schedule",), "an optax transformation: the TrainState holds the optimizer, "
                             "the step sets its scheduled learning rate"),
    "platforms": (("device",), "jax.export's platforms: a program is exported for a device"),
    "params": (("model",), "Flax variables: a torch module holds its parameters"),
    "variables": (("model", "state"), "Flax variables: a torch module (or its state dict)"),
    "batch_stats": (("model",), "Flax's batch_stats: the BatchNorm modules' buffers"),
    "opt_state": (("optimizer",), "optax's state: the torch optimizer's"),
}

# Parameters of one JAX function the port spells otherwise: {qualified name:
# {parameter: (the port's name, reason)}}
RENAMED = {
    "data.iterator.make_feed": {
        "stage": ("device", "the port stages to a torch device itself (pinned copies on a side "
                            "stream)")},
    "nn.layers.masked_max": {"axis": ("dim", "torch's name for a reduced axis")},
    "nn.layers.masked_mean": {"axis": ("dim", "torch's name for a reduced axis")},
    "parallel.mesh.make_mesh": {
        "n_devices": ("n_ranks", "a rank a process of torch.distributed")},
    "parallel.mesh.replicate": {
        "tree": ("module", "the parameters to replicate are a module's")},
    "parallel.points.sharded_backbone_body": {
        "cfg": ("backbone", "the Backbone module holds its config"),
        "nshards": ("mesh", "PointMesh holds the row's size"),
        "bb_vars": ("backbone", "the Backbone module holds its variables"),
        "train": ("backbone", "the module's training mode")},
    "serve.export.save_artifact": {
        "exported": ("programs", "one torch.export program a platform")},
    "train.checkpoint.CheckpointManager.save": {
        "step": ("state", "the TrainState holds its step")},
    "train.checkpoint.CheckpointManager.restore": {
        "abstract_state": ("state", "the TrainState restored in place")},
    "train.checkpoint.CheckpointManager.restore_params": {
        "abstract_variables": ("variables", "a model or state dict whose keys are read")},
    "train.checkpoint.load_stage1_params": {
        "abstract_state": ("abstract", "a model or TrainState whose parameter names are read")},
    "train.steps.make_gspn_loss_fn": {
        "model": ("loss_fn", "the model is the loss function's first argument")},
    "train.steps.make_rpointnet_loss_fn": {
        "model": ("loss_fn", "the model is the loss function's first argument")},
    "train.steps.make_gspn_train_step": {
        "model": ("step", "the TrainState passed to the step holds the model")},
}

# Public JAX names the port does not carry: {qualified name: reason}
NOT_CARRIED_NAMES = {
    "data.iterator.DevicePrefetcher": "replaced by make_feed, which stages the next batches "
                                      "on a side CUDA stream in the trainers' loop",
    "train.schedules.resolve_bn_momentum": "moot beside train.steps.set_bn_momentum, which "
                                           "sets each BatchNorm's momentum before a step",
    "train.schedules.reblend_batch_stats": "moot beside train.steps.set_bn_momentum: no "
                                           "static momentum's update is inverted after a step",
    "train.checkpoint.CheckpointManager.close": "orbax's asynchronous saver: the port's save "
                                                "writes its file before it returns",
    "train.steps.TrainState.create": "flax's constructor from variables and an optax tx: "
                                     "TrainState(model, make_optimizer(model, lr))",
    "utils.debug.interpret_kernels": "Pallas's interpret mode: a CUDA kernel has none; "
                                     "utils.debug.plain_kernels runs the plain versions instead",
    **{f"{qual}.replace": "flax.struct's copy with changes: dataclasses.replace does it for "
                         "the port's dataclasses"
       for qual in ("models.gspn.GSPNOutputs", "models.pipeline.InstancePredictions",
                    "models.rpointnet.RoIOutputs", "models.rpointnet.RoIMatch",
                    "train.steps.TrainState")},
}

# JAX parameters the port does not carry: {qualified name: {parameter: reason}}
NOT_CARRIED = {
    qual: {"model_bn_momentum": "moot: the port sets each BatchNorm's momentum before a step "
                                "(train.steps.set_bn_momentum), so no static momentum is "
                                "inverted after it"}
    for qual in ("train.steps.make_train_step", "parallel.dp.make_dp_train_step",
                 "parallel.train_points.make_point_sharded_gspn_train_step",
                 "parallel.train_points.make_point_sharded_rpointnet_train_step")
}
NOT_CARRIED["models.gspn.GSPNConfig"] = {
    "bn_axis": "a mesh axis in the config: the port's BatchNorms take a process group "
               "(nn.layers.cross_rank_statistics)"}
NOT_CARRIED["models.rpointnet.RPointNetConfig"] = dict(NOT_CARRIED["models.gspn.GSPNConfig"])
NOT_CARRIED["serve.export.export_inference"] = {
    "feature_dim": "the PipelineConfig fixes the per-point feature width the program takes"}
NOT_CARRIED["train.checkpoint.CheckpointManager.save"] = {
    "force": "orbax's override of its save interval: the port writes every save asked for"}
NOT_CARRIED["utils.profiling.StepTimer.stop"] = {
    "outputs": "arrays to wait for: on the card a CUDA event closes the step"}
NOT_CARRIED["utils.debug.checked"] = {
    "errors": "checkify's error sets: the port checks the floating outputs for NaN and inf"}

# Defaults the port sets otherwise on purpose: {qualified name: {parameter: reason}}
DEFAULTS_DIFFER = {
    "models.pipeline.init_pipeline_variables": {
        "feature_dim": "None takes the stage configs' widths; a width given must equal theirs, "
                       "as JAX's 0 must"},
}


def _modules() -> list[str]:
    root = REPO / "gspn_tpu"
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if p.name != "__init__.py" and str(p.relative_to(root)) not in TPU_ONLY)


def _dotted(path: str) -> str:
    return path.removesuffix(".py").replace("/", ".")


def _public(module) -> dict:
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == module.__name__}


def _members(module) -> dict:
    """The module's public functions and classes, and the public methods
    its classes define, by ``Name`` / ``Class.method``."""
    out = {}
    for name, obj in _public(module).items():
        out[name] = obj
        if inspect.isclass(obj):
            for m, f in vars(obj).items():
                if not m.startswith("_") and isinstance(f, (classmethod, staticmethod)):
                    out[f"{name}.{m}"] = f.__func__
                elif not m.startswith("_") and inspect.isfunction(f):
                    out[f"{name}.{m}"] = f
    return out


def _port(module, name: str):
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part, None)
    return obj


def _params(obj) -> dict:
    return {k: p for k, p in inspect.signature(obj).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and k not in ("self", "cls")}


def _literal(v) -> bool:
    if isinstance(v, tuple):
        return all(map(_literal, v))
    return v is None or isinstance(v, (bool, int, float, str))


def _pairs(path: str):
    """``(qualified name, JAX object, port object or None)`` of each of
    the module's members."""
    dotted = _dotted(path)
    jmod = importlib.import_module(f"gspn_tpu.{dotted}")
    tmod = importlib.import_module(f"gspn_tpu_torch.{dotted}")
    return [(f"{dotted}.{name}", obj, _port(tmod, name))
            for name, obj in _members(jmod).items()]


def _gaps(path: str) -> tuple[list[str], set]:
    """Every JAX name and parameter of ``path`` the port lacks and no table
    accounts for, and the table entries used."""
    gaps, used = [], set()
    for qual, obj, port in _pairs(path):
        if port is None:
            if qual in NOT_CARRIED_NAMES:
                used.add(("NOT_CARRIED_NAMES", qual))
            elif qual.rsplit(".", 1)[0] not in NOT_CARRIED_NAMES:  # not a method of one
                gaps.append(f"{qual}: absent")
            continue
        have = _params(port)
        for p in _params(obj):
            if p in have:
                continue
            if p in NOT_CARRIED.get(qual, {}):
                used.add(("NOT_CARRIED", qual, p))
            elif p in RENAMED.get(qual, {}):
                new = RENAMED[qual][p][0]
                used.add(("RENAMED", qual, p))
                if new not in have and new not in ("loss_fn", "step"):
                    gaps.append(f"{qual}: {p} -> {new}, which the port lacks")
            elif p in RENAMED_EVERYWHERE:
                used.add(("RENAMED_EVERYWHERE", p))
            else:
                gaps.append(f"{qual}: parameter {p!r}")
    return gaps, used


def _stale(dotted: str, used: set) -> list[str]:
    """The table entries of module ``dotted`` that no gap used."""
    mine = (lambda qual: qual.startswith(dotted + "."))
    stale = [f"NOT_CARRIED_NAMES {q}" for q in NOT_CARRIED_NAMES
             if mine(q) and ("NOT_CARRIED_NAMES", q) not in used]
    stale += [f"{kind} {qual}.{p}" for kind, table in (("RENAMED", RENAMED),
                                                        ("NOT_CARRIED", NOT_CARRIED))
              for qual, entries in table.items() if mine(qual)
              for p in entries if (kind, qual, p) not in used]
    return stale


@pytest.mark.parametrize("path", _modules())
def test_port_carries_every_jax_name_and_parameter(path):
    """Each module's public functions, classes and methods, and each
    parameter of theirs, are the port's, or in a table with a reason; a
    table entry of this module that the port no longer needs fails too."""
    assert (REPO / "gspn_tpu_torch" / path).is_file(), f"gspn_tpu_torch/{path} is missing"
    gaps, used = _gaps(path)
    assert not gaps, gaps
    stale = _stale(_dotted(path), used)
    assert not stale, stale


@pytest.mark.parametrize("path", _modules())
def test_port_defaults_are_the_jax_defaults(path):
    """Each parameter the port shares with the JAX function has JAX's
    default where both defaults are plain literals (numbers, bools,
    strings, None, tuples of them), or stands in ``DEFAULTS_DIFFER``."""
    differ, used = [], set()
    for qual, obj, port in _pairs(path):
        if port is None:
            continue
        have = _params(port)
        for k, p in _params(obj).items():
            q = have.get(k)
            if q is None or not (_literal(p.default) and _literal(q.default)):
                continue
            if p.default == q.default and type(p.default) is type(q.default):
                continue
            if k in DEFAULTS_DIFFER.get(qual, {}):
                used.add((qual, k))
            else:
                differ.append(f"{qual}({k}): JAX {p.default!r}, the port {q.default!r}")
    assert not differ, differ
    stale = [f"{qual}.{k}" for qual, entries in DEFAULTS_DIFFER.items()
             if qual.startswith(_dotted(path) + ".") for k in entries if (qual, k) not in used]
    assert not stale, stale


def test_tables_hold_reasons_and_name_modules_that_exist():
    """Every table entry has a one-line reason, every module it names is a
    JAX module the test scans, and every global rename is used."""
    dotted = [_dotted(p) for p in _modules()]
    quals = [*RENAMED, *NOT_CARRIED, *NOT_CARRIED_NAMES, *DEFAULTS_DIFFER]
    for qual in quals:
        assert any(qual.startswith(d + ".") for d in dotted), qual
    reasons = [*NOT_CARRIED_NAMES.values(),
               *(e[1] if isinstance(e, tuple) else e
                 for table in (RENAMED, NOT_CARRIED, DEFAULTS_DIFFER)
                 for entries in table.values() for e in entries.values())]
    assert all(r and "\n" not in r for r in reasons)
    used = set().union(*(_gaps(p)[1] for p in _modules()))
    unused = [p for p in RENAMED_EVERYWHERE if ("RENAMED_EVERYWHERE", p) not in used]
    assert not unused, unused
    for path in TPU_ONLY:
        assert (REPO / "gspn_tpu" / path).is_file() and not (
            REPO / "gspn_tpu_torch" / path).exists(), path
