"""The port's public surface against the JAX package's, name by name.

Every module of ``visiondepth3d_tpu`` is parsed with ``ast`` (nothing of
JAX is imported) for its public names: what a package ``__init__`` imports
or lists in ``__all__``, and every public top-level function and class with
its public methods. Each must exist at the same path in
``visiondepth3d_tpu_torch``, and a function's positional parameters must
equal the JAX function's by name and in order; the port may add parameters
after them, each with a default (``device``, ``generator``). A name or a
signature the port does not carry is an entry of ``NOT_CARRIED``: the JAX
path (a module's, to cover the whole module), the port's counterpart (a
dotted path that must import, or None) and one of ``REASONS``.
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import pytest
import torch
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "visiondepth3d_tpu"
PORT_PKG = "visiondepth3d_tpu_torch"

MACHINERY = "JAX or GSPMD machinery with a different form in the port"
CONVERTER = "HF -> Flax converter: the port keeps the upstream names"
SUBMODULE = "Flax submodule class that the port names after HF"
RENAMED = "renamed: the counterpart is named"
BENCHMARK = "the benchmark's own"
REASONS = (MACHINERY, CONVERTER, SUBMODULE, RENAMED, BENCHMARK)

# JAX path (under visiondepth3d_tpu) -> (the port's counterpart, under
# visiondepth3d_tpu_torch unless it starts with "torch.", or None; reason)
_NOT_CARRIED = {
    # the benchmark's command and the reference oracle's loop (ROADMAP F1)
    "cli.main.cmd_bench": (None, BENCHMARK),
    "utils.refloop": (None, BENCHMARK),
    # Pallas kernels and their VMEM tiling helpers: hand-written CUDA in kernels/
    "ops.pallas_attention.vmem_attention": ("kernels.attention.vmem_attention", MACHINERY),
    "ops.pallas_conv.conv3x3_pallas": ("kernels.conv.conv3x3", MACHINERY),
    "ops.pallas_conv.pick_conv_block_rows": (None, MACHINERY),
    "ops.pallas_dof.dof_grade_pallas": ("kernels.dof.dof_grade", MACHINERY),
    "ops.pallas_dof.dof_reach": ("kernels.dof.dof_reach", MACHINERY),
    "ops.pallas_postfx.feather_heal_pallas": ("kernels.postfx.feather_heal", MACHINERY),
    "ops.pallas_postfx.pick_block_rows": (None, MACHINERY),
    "ops.pallas_stats.fits_vmem": (None, MACHINERY),
    "ops.pallas_stats.quantile_pair_pallas": ("kernels.stats.quantile_pair", MACHINERY),
    "ops.pallas_stats.subject_stats_pallas": ("kernels.stats.subject_stats", MACHINERY),
    "ops.pallas_warp.stereo_warp_pallas": ("kernels.warp.stereo_warp", MACHINERY),
    # jax.nn's sigmoid spelled out; XLA matmul precision of the resize
    "ops.edges.jax_sigmoid": ("torch.sigmoid", MACHINERY),
    "ops.resize.resize_bilinear": ("ops.resize.resize_bilinear", MACHINERY),
    # GSPMD shardings and shard_map collectives: the port splits the data
    # over a list of devices itself (parallel/)
    "parallel.frame_dp_sharding": ("parallel.segment_bounds", MACHINERY),
    "parallel.spatial_sharding": ("parallel.band_bounds", MACHINERY),
    "parallel.replicated": ("parallel.replicate", MACHINERY),
    "parallel.shard_params": ("parallel.tp.shard_module", MACHINERY),
    "parallel.vit_param_spec": ("parallel.tp.split_plan", MACHINERY),
    "parallel.mesh.frame_dp_sharding": ("parallel.dp.segment_bounds", MACHINERY),
    "parallel.mesh.spatial_sharding": ("parallel.halo.band_bounds", MACHINERY),
    "parallel.mesh.replicated": ("parallel.mesh.replicate", MACHINERY),
    "parallel.tp.shard_params": ("parallel.tp.shard_module", MACHINERY),
    "parallel.tp.vit_param_spec": ("parallel.tp.split_plan", MACHINERY),
    "parallel.halo.halo_exchange_rows": ("parallel.halo.halo_exchange_rows", MACHINERY),
    "pipeline.depth_pipeline.make_depth_batch_fn":
        ("pipeline.depth_pipeline.make_depth_batch_fn", MACHINERY),
    "pipeline.mesh_render.make_chunk_fn_batched":
        ("pipeline.mesh_render.render_stereo_video_mesh", MACHINERY),
    "pipeline.stereo_pipeline.make_chunk_body":
        ("pipeline.stereo_pipeline.make_chunk_fn", MACHINERY),
    "enhance.pipeline.make_enhance_fn": ("enhance.pipeline.make_enhance_fn", MACHINERY),
    # Flax keeps the params apart from the module and initialises from a
    # sample input; an nn.Module holds its weights and needs none
    "depth.model.init_random_model_args": ("depth.model.build_random_model", MACHINERY),
    "depth.diffusion.vae.AutoencoderKL.setup": (None, MACHINERY),
    "enhance.esrgan.apply_rrdbnet_staged": ("enhance.esrgan.apply_rrdbnet_staged", MACHINERY),
    "enhance.pipeline.init_enhance_params": ("enhance.pipeline.init_enhance_params", MACHINERY),
    "enhance.rife.interpolate_pairs": ("enhance.rife.interpolate_pairs", MACHINERY),
    "train.trainer.Trainer.init": ("train.trainer.Trainer.init", MACHINERY),
    "train.trainer.Trainer.make_train_step": ("train.trainer.Trainer.step", MACHINERY),
    # HF -> Flax weight converters: the port's modules take HF state dicts
    "depth.convert.convert_depth_anything": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.convert_dpt": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.depth_pro.convert_depth_pro": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.dpt_beit.convert_dpt_beit": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.dpt_hybrid.convert_dpt_hybrid": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.zoedepth.convert_zoedepth": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.zoedepth.convert_zoedepth_nk": ("depth.convert.load_hf_state_dict", CONVERTER),
    "depth.diffusion.convert_diffusers": ("depth.diffusion.load_diffusers_state", CONVERTER),
    "depth.diffusion.convert_clip_vision": ("depth.diffusion.load_diffusers_state", CONVERTER),
    "depth.diffusion.convert_unet2d": ("depth.diffusion.load_diffusers_state", CONVERTER),
    "depth.diffusion.convert_unet_st": ("depth.diffusion.load_diffusers_state", CONVERTER),
    "depth.diffusion.convert_vae": ("depth.diffusion.load_diffusers_state", CONVERTER),
    "enhance.convert_rrdbnet": ("enhance.convert_esrgan", CONVERTER),
    "enhance.esrgan.convert_rrdbnet": ("enhance.esrgan.convert_esrgan", CONVERTER),
    # Flax submodules; the port's modules carry HF's names and layout
    "depth.beit.BEiTBlock": ("depth.beit.BEiTLayer", SUBMODULE),
    "depth.bit.WSConv": ("depth.bit.WSConv2d", SUBMODULE),
    "depth.bit.GNAct": ("torch.nn.GroupNorm", SUBMODULE),
    "depth.diffusion.clip_vision.CLIPBlock": ("depth.diffusion.clip_vision._Layer", SUBMODULE),
    "depth.diffusion.unet_st.SpatialResnet": ("depth.diffusion.vae.ResnetBlock", SUBMODULE),
    "depth.diffusion.unet_st.TransformerLayer":
        ("depth.diffusion.unet2d.TransformerBlock", SUBMODULE),
    "depth.dinov2.PatchEmbed": ("depth.dinov2.PatchEmbeddings", SUBMODULE),
    "depth.dpt.UpsampleConv": ("torch.nn.ConvTranspose2d", SUBMODULE),
    "depth.dpt.DPTNeckHead": ("depth.dpt.Neck", SUBMODULE),
    "depth.dpt_classic.ViTClassicBackbone": ("depth.dpt_classic._DPTViT", SUBMODULE),
    "depth.midas_v2.ResidualUnit": ("depth.midas_v2.ResidualConvUnit", SUBMODULE),
    "depth.zoedepth.Projector": ("depth.zoedepth._TwoConv", SUBMODULE),
    "depth.zoedepth.SeedBinRegressorSmall": ("depth.zoedepth.SeedBinRegressor", SUBMODULE),
    # the port builds a random module where the JAX package draws params
    "depth.init_random": ("depth.build_random", RENAMED),
    "depth.model.init_random": ("depth.model.build_random", RENAMED),
    "depth.model.init_random_model": ("depth.model.build_random_model", RENAMED),
    "depth.convert.load_safetensors_state": ("depth.convert.load_safetensors", RENAMED),
    "utils.memory.device_hbm_bytes": ("utils.memory.device_memory_bytes", RENAMED),
}

NOT_CARRIED: dict[str, tuple[str | None, str]] = {
    f"{JAX_PKG}.{key}": (counterpart if counterpart is None or counterpart.startswith("torch.")
                         else f"{PORT_PKG}.{counterpart}", reason)
    for key, (counterpart, reason) in _NOT_CARRIED.items()}


def _jax_modules() -> dict[str, Path]:
    out = {}
    for path in sorted((REPO / JAX_PKG).rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        out[".".join(parts)] = path
    return out


JAX_MODULES = _jax_modules()


def _decorators(node) -> set[str]:
    names = set()
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        names.add(d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", ""))
    return names


def _positional(node, method: bool) -> list[str]:
    names = [a.arg for a in node.args.posonlyargs + node.args.args]
    return names[1:] if method and "staticmethod" not in _decorators(node) else names


def public_surface(path: Path) -> dict[str, list[str] | None]:
    """name (``Class.method`` for a method) -> the positional parameters of
    a function or method, or None for a class, a property or an exported
    name."""
    tree = ast.parse(path.read_text())
    out: dict[str, list[str] | None] = {}
    for node in tree.body:
        if path.name == "__init__.py" and isinstance(node, (ast.ImportFrom, ast.Import)):
            out.update({(a.asname or a.name).split(".")[0]: None for a in node.names})
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__"
                                                   for t in node.targets):
            out.update({elt.value: None for elt in node.value.elts})
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _positional(node, method=False)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_"):
                    prop = _decorators(sub) & {"property", "cached_property", "setter"}
                    out[f"{node.name}.{sub.name}"] = None if prop else _positional(sub, True)
    return out


def resolve(dotted: str):
    """The object at a dotted path (module, then attributes), or raise."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for name in parts[i:]:
            obj = getattr(obj, name)
        return obj
    raise ModuleNotFoundError(dotted)


def port_positional(owner, name: str) -> list[str] | None:
    """The positional parameters of the port's function or method ``name``
    of ``owner`` (a module or a class), or None when it is not a function."""
    fn = getattr(owner, name)
    is_static = isinstance(inspect.getattr_static(owner, name, fn), staticmethod)
    if not (inspect.isfunction(inspect.unwrap(fn)) or inspect.ismethod(fn)):
        return None
    params = [p.name for p in inspect.signature(fn).parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if inspect.isclass(owner) and not is_static and not inspect.ismethod(fn):
        params = params[1:]
    return params


def signature_gap(fn_owner, name: str, want: list[str]) -> str | None:
    got = port_positional(fn_owner, name)
    if got is None:
        return None
    sig = inspect.signature(getattr(fn_owner, name)).parameters
    extra = got[len(want):]
    if got[:len(want)] != want or any(sig[p].default is inspect.Parameter.empty
                                      for p in extra):
        return f"positional parameters {got}, JAX {want}"
    return None


def check_module(jax_mod: str) -> list[str]:
    """The names of ``jax_mod`` the port neither carries nor lists, as
    messages."""
    port_mod = PORT_PKG + jax_mod[len(JAX_PKG):]
    if jax_mod in NOT_CARRIED:
        return []
    try:
        module = importlib.import_module(port_mod)
    except ModuleNotFoundError:
        module = None
    problems = []
    for name, want in public_surface(JAX_MODULES[jax_mod]).items():
        key = f"{jax_mod}.{name}"
        if key in NOT_CARRIED:
            continue
        owner, obj = module, module
        try:
            for part in name.split("."):
                owner, obj = obj, getattr(obj, part)
        except AttributeError:
            problems.append(f"{key}: not in {port_mod}")
            continue
        if want is not None:
            gap = signature_gap(owner, name.split(".")[-1], want)
            if gap:
                problems.append(f"{key}: {gap}")
    return problems


@pytest.mark.parametrize("jax_mod", sorted(JAX_MODULES))
def test_module_surface_is_carried(jax_mod):
    problems = check_module(jax_mod)
    assert not problems, "\n".join(problems)


def test_not_carried_entries_are_current():
    """Every NOT_CARRIED entry names a path of the JAX tree, gives one of
    the reasons and a counterpart that imports, and is needed: the port
    lacks the name at the same path, or its signature differs."""
    stale = []
    for key, (counterpart, reason) in list(NOT_CARRIED.items()):
        if reason not in REASONS:
            stale.append(f"{key}: reason {reason!r}")
        if counterpart is not None:
            try:
                resolve(counterpart)
            except (ImportError, AttributeError) as e:
                stale.append(f"{key}: counterpart {counterpart} does not import ({e!r})")
        if key in JAX_MODULES:
            continue
        mod = max((m for m in JAX_MODULES if key.startswith(m + ".")), key=len, default=None)
        name = key[len(mod) + 1:] if mod else None
        surface = public_surface(JAX_MODULES[mod]) if mod else {}
        if name not in surface:
            stale.append(f"{key}: not in the JAX tree")
            continue
        saved = NOT_CARRIED.pop(key)
        try:
            needed = any(p.startswith(key + ":") for p in check_module(mod))
        finally:
            NOT_CARRIED[key] = saved
        if not needed:
            stale.append(f"{key}: the port carries it at the same path")
    assert not stale, "\n".join(stale)
