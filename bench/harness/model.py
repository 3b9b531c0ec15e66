"""The configuration, the weights and the prompt latents of a cell: the
benchmark's inputs, made here from the seed and handed to the program and
to the plain reference alike."""
from __future__ import annotations

import dataclasses

import torch

NORMS = ("ln1", "ln2", "ln_f", "q_norm", "kv_norm")
EXPERT_STACKS = ("w_gate", "w_up", "w_down")
NORM_EPS = 1e-6


def dims(conf: dict) -> dict:
    """The widths the program and the reference read, from a configuration
    file's keys (the Hugging Face names of DeepSeek's config.json). Where the
    port runs the model otherwise than the source, the file's ``port`` group
    states it under the same name, and that is what is read."""
    experts = conf.get("n_routed_experts") or 0
    port = conf.get("port", {})
    if conf.get("qk_nope_head_dim") != conf.get("v_head_dim"):
        raise ValueError("the port's MLA takes qk_nope_head_dim == v_head_dim")
    if conf.get("num_key_value_heads", conf["num_attention_heads"]) != conf["num_attention_heads"]:
        raise ValueError("MLA has one latent per token: num_key_value_heads == heads")
    if conf.get("rms_norm_eps", NORM_EPS) != NORM_EPS:
        raise ValueError(f"the port's RMSNorm uses eps {NORM_EPS}")
    out = dict(
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"], d_head=conf["qk_nope_head_dim"],
        d_rope=conf["qk_rope_head_dim"], d_c=conf["kv_lora_rank"],
        q_lora_rank=conf.get("q_lora_rank") or 0, vocab_size=conf["vocab_size"],
        rope_theta=float(conf["rope_theta"]),
        tie=bool(port.get("tie_word_embeddings", conf.get("tie_word_embeddings", True))),
        d_ff=0 if experts else conf["intermediate_size"], moe=None)
    if experts:
        out["moe"] = dict(n_experts=experts, top_k=conf["num_experts_per_tok"],
                          d_ff_expert=conf["moe_intermediate_size"],
                          n_shared_experts=conf.get("n_shared_experts") or 0,
                          capacity_factor=float(port["capacity_factor"]),
                          renorm_topk=bool(conf.get("norm_topk_prob", True)))
    return out


def port_config(conf: dict, **serve):
    """The program's ``ModelConfig`` for a configuration file, with the
    serving options ``serve`` (kv_fmt, page_size, kv_paged, ...)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLADims
    from repro_torch.models.moe import MoEConfig
    d = dims(conf)
    moe = None
    if d["moe"]:
        moe = MoEConfig(**d["moe"])
    base = get_config(conf["port"]["arch"])
    return dataclasses.replace(
        base, n_layers=d["n_layers"], d_model=d["d_model"], n_heads=d["n_heads"],
        n_kv_heads=d["n_heads"], d_head=d["d_head"], d_ff=d["d_ff"],
        vocab_size=d["vocab_size"], rope_theta=d["rope_theta"], moe=moe,
        first_k_dense=conf.get("port", {}).get("first_k_dense_replace",
                                               conf.get("first_k_dense_replace", 0)),
        mla=MLADims(d_c=d["d_c"], d_rope=d["d_rope"], q_lora_rank=d["q_lora_rank"]),
        tie_embeddings=d["tie"], **serve)


def _std(owner: str, name: str, shape) -> float | None:
    """The port's initialisation scale of a leaf (``models/layers._normal``
    callers); None for a norm gain (ones)."""
    if name in NORMS:
        return None
    if name in ("embed", "unembed"):
        return 0.02
    if name == "w_o":
        return (shape[0] * shape[1]) ** -0.5
    if owner == "MoEParams" and name in EXPERT_STACKS:
        return shape[1] ** -0.5
    return shape[0] ** -0.5


def make_weights(cfg, seed: int, device, chunk: int = 1 << 28):
    """The program's parameter tree for ``cfg`` (the layout of
    ``transformer.init_model``), float32, drawn on ``device`` from one
    generator seeded with ``seed`` into one flat buffer in a few large calls,
    each leaf scaled as the port initialises it; norm gains are ones."""
    from repro_torch.models import transformer as T
    meta = T.init_model(torch.Generator(), cfg, device="meta")
    leaves = []                                         # (owner, name, shape)

    def walk(node, owner, name):
        if isinstance(node, torch.Tensor):
            leaves.append((owner, name, tuple(node.shape)))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, "dict", k)
        elif isinstance(node, list):
            for v in node:
                walk(v, owner, name)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, type(node).__name__, k)
    walk(meta, "dict", "")
    sizes = [int(torch.Size(s).numel()) if _std(o, n, s) is not None else 0
             for o, n, s in leaves]
    flat = torch.empty((sum(sizes),), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for a in range(0, flat.numel(), chunk):
        flat[a:a + chunk].normal_(generator=gen)
    it = iter(zip(leaves, sizes))
    offset = [0]

    def build(node):
        if isinstance(node, torch.Tensor):
            (owner, name, shape), size = next(it)
            std = _std(owner, name, shape)
            if std is None:
                return torch.ones(shape, dtype=torch.float32, device=device)
            leaf = flat[offset[0]:offset[0] + size].view(shape)
            offset[0] += size
            return leaf.mul_(std)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(None if v is None else build(v) for v in node))
        return node
    return build(meta)


def plain_weights(params) -> dict:
    """The same tensors as plain dicts, for the reference."""
    def fields(nt):
        return {k: v for k, v in zip(nt._fields, nt)}
    out = {"embed": params["embed"], "ln_f": params["ln_f"],
           "layers": [{"ln1": p["ln1"], "ln2": p["ln2"], "mla": fields(p["mixer"]),
                       "mlp": fields(p["mlp"])} for p in params["layers"]]}
    if "unembed" in params:
        out["unembed"] = params["unembed"]
    return out


def _rms(x, gain):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + NORM_EPS) * gain


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return x * torch.cos(ang) + torch.cat([-x[:, half:], x[:, :half]], dim=-1) * torch.sin(ang)


class PromptLatents:
    """The prompt's latent KV of every layer, a stand-in for what prefill
    would write: layer l's own projection (RMSNorm ``ln1``, ``W_DKV`` and
    ``kv_norm``, ``W_KR`` and RoPE at each position) of the prompt tokens'
    embeddings. For layer 0 that is exactly what prefill computes. Each row
    and block of positions is computed on its own, so a subset of rows gets
    the same bits as the whole batch."""

    def __init__(self, weights: dict, tokens: torch.Tensor, theta: float):
        self.w, self.tokens, self.theta = weights, tokens, theta

    def __call__(self, layer: int, t0: int, t1: int, rows=None):
        lw = self.w["layers"][layer]
        m = lw["mla"]
        rows = range(self.tokens.shape[0]) if rows is None else rows
        pos = torch.arange(t0, t1, device=self.tokens.device)
        cs, ks = [], []
        for b in rows:
            x = _rms(self.w["embed"][self.tokens[b, t0:t1].long()], lw["ln1"])
            cs.append(_rms(x @ m["w_dkv"], m["kv_norm"]))
            ks.append(_rope(x @ m["w_kr"], pos, self.theta))
        return torch.stack(cs), torch.stack(ks)

    def rows(self, rows):
        """The same latents for a subset of rows, as the reference asks."""
        return lambda layer, t0, t1: self(layer, t0, t1, rows)
