"""Local HF-cache resolution of SD component files.

Counterpart of `cake_tpu/models/sd/hub.py` (`_component_repo_file`,
`resolve_sd_asset`), with JAX's per-version repo and file mapping and
its repo aliases. Resolution order:
  1. an explicit file path (returned verbatim),
  2. the local HF cache, read by the port itself from the cache's
     `models--org--name/snapshots/<ref>/path` layout (`refs/<revision>`
     names the snapshot; a revision without a ref is a snapshot name),
     under `cache_dir`, else $HF_HUB_CACHE, $HF_HOME/hub or
     ~/.cache/huggingface/hub.
A miss raises JAX's actionable FileNotFoundError naming the (repo,
file) it wanted. Unlike the JAX package, the port never downloads,
whatever $HF_HUB_OFFLINE says: the machines it runs on have no network,
and it has no `huggingface_hub`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger(__name__)

# version -> base diffusers repo. runwayml/stable-diffusion-v1-5 left the
# hub in 2024: the maintained mirror is the repo, and the legacy name a
# cache alias, so caches filled under it still resolve.
_REPOS = {
    "v1-5": "stable-diffusion-v1-5/stable-diffusion-v1-5",
    "v2-1": "stabilityai/stable-diffusion-2-1",
    "xl": "stabilityai/stable-diffusion-xl-base-1.0",
    "turbo": "stabilityai/sdxl-turbo",
}
_REPO_CACHE_ALIASES = {
    "stable-diffusion-v1-5/stable-diffusion-v1-5": (
        "runwayml/stable-diffusion-v1-5",),
}

# tokenizer repos
_TOKENIZER_REPOS = {
    "v1-5": "openai/clip-vit-base-patch32",
    "v2-1": "openai/clip-vit-base-patch32",
    "xl": "openai/clip-vit-large-patch14",
    "turbo": "openai/clip-vit-large-patch14",
}
_TOKENIZER2_REPO = "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k"

# the fp16 SDXL VAE is numerically broken upstream; diffusers substitutes
# the community fix
_SDXL_VAE_FP16_FIX = ("madebyollin/sdxl-vae-fp16-fix",
                      "diffusion_pytorch_model.safetensors")


def _component_repo_file(component: str, version: str, use_f16: bool):
    v = getattr(version, "value", version)  # SDVersion enum or str
    if v not in _REPOS:
        raise ValueError(f"unknown SD version '{v}'")
    suffix = ".fp16.safetensors" if use_f16 else ".safetensors"
    if component == "tokenizer":
        return _TOKENIZER_REPOS[v], "tokenizer.json"
    if component == "tokenizer_2":
        return _TOKENIZER2_REPO, "tokenizer.json"
    if component == "clip":
        return _REPOS[v], f"text_encoder/model{suffix}"
    if component == "clip2":
        return _REPOS[v], f"text_encoder_2/model{suffix}"
    if component == "unet":
        return _REPOS[v], f"unet/diffusion_pytorch_model{suffix}"
    if component == "vae":
        if v in ("xl", "turbo") and use_f16:
            return _SDXL_VAE_FP16_FIX
        return _REPOS[v], f"vae/diffusion_pytorch_model{suffix}"
    raise ValueError(f"unknown SD component '{component}'")


def hf_cache_dir(cache_dir: Optional[str] = None) -> str:
    """The HF hub cache directory huggingface_hub itself would read."""
    if cache_dir:
        return cache_dir
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def cached_file(repo: str, path: str, cache_dir: Optional[str] = None,
                revision: str = "main") -> Optional[str]:
    """`<cache>/models--org--name/snapshots/<commit>/<path>` when it
    exists (the commit read from `refs/<revision>`, or the revision
    itself when no such ref exists), else None."""
    root = os.path.join(hf_cache_dir(cache_dir),
                        "models--" + repo.replace("/", "--"))
    ref = os.path.join(root, "refs", revision)
    commit = revision
    if os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
    found = os.path.join(root, "snapshots", commit, path)
    return found if os.path.exists(found) else None


def resolve_sd_asset(component: str, version, *,
                     filename: Optional[str] = None, use_f16: bool = True,
                     cache_dir: Optional[str] = None) -> str:
    """Path to a component's weights or tokenizer file (see the module
    docstring). component: tokenizer | tokenizer_2 | clip | clip2 |
    unet | vae."""
    if filename:
        return filename
    repo, path = _component_repo_file(component, version, use_f16)
    for candidate in (repo, *_REPO_CACHE_ALIASES.get(repo, ())):
        hit = cached_file(candidate, path, cache_dir)
        if hit is not None:
            log.info("sd: %s resolved from HF cache: %s", component, hit)
            return hit
    raise FileNotFoundError(
        f"SD {component}: {repo}/{path} not in the local HF cache and "
        "the port does not download; pre-populate the cache or pass an "
        "explicit path")
