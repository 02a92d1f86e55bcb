#!/usr/bin/env python3
"""Why a bf16 Llama-4-Scout group run leaves the solo run's first step:
the two runs' MoE routing choices, request by request, beside the
first-step logits.

    python3 scripts/group_moe_routing.py [--depth 13]

Full width, cut to ``--depth`` layers, bf16, random weights from seed 0:
chip_smoke.py's [groups] (c) serve (8 Poisson requests, 32 new tokens),
solo and with every server on a (4, 2) group of slots on the card, once at
the config's capacity factor and once at n_experts / top_k, where no
prefill token is dropped.  For each: the MoE drop fractions; how many
(prompt token, layer) top-1 choices differ between the runs (a group's
choices are its slots' row blocks put back together); and per request,
its first-step logits difference over the solo logit scale, the layers
at which its last prompt token (the one the first step reads) took
another expert, and how many of its prompt tokens did so at some layer.  Prints the card's name and power limit.  Needs a CUDA device.
"""
import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    ap.add_argument("--depth", type=int, default=S.SCOUT_DEPTH)
    args = ap.parse_args()
    import numpy as np
    import torch

    import repro_torch.core as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GroupMesh
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.engine import BlockServer, GeoServingSystem

    if not torch.cuda.is_available():
        print("group_moe_routing.py: no CUDA device", file=sys.stderr)
        return 2
    S.log(S.nvidia_smi_line())
    S.phase_build()
    base = get_config("llama4_scout_17b_a16e").replace(n_layers=args.depth)
    params = init_params(base, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    devs = np.empty(S.SCOUT_MESH[0] * S.SCOUT_MESH[1], dtype=object)
    devs[:] = S.slot_devices(torch, devs.size)
    mesh = GroupMesh(devs.reshape(S.SCOUT_MESH))
    n_data, n_slots = S.SCOUT_MESH[0], devs.size
    real = (moe_mod.router_topk, GeoServingSystem._prefill_group_round,
            BlockServer.prefill_rows)
    state = {"system": None, "call": None}

    def router(p, cfg_, xf):
        out = real[0](p, cfg_, xf)
        if state["call"] is not None:
            state["call"]["top1"].append(out[1][:, 0].clone())
        return out

    def group_round(self, g):
        state["system"] = self
        return real[1](self, g)

    def serve(tag, cfg, problem, **kw):
        calls = []

        def prefill_rows(self, h_rows, layer_active, offset=0, *a, **k):
            act = layer_active.cpu().numpy()  # (hosted layers, rows)
            sid_of = {row: sid for sid, row in self.pool.rows.items()}
            sess = state["system"].sessions
            call = {"offset": offset, "shape": tuple(h_rows.shape[:2]),
                    "first_layer": self.a, "active": act,
                    "rows": {int(r): sess[sid_of[r]]
                             for r in np.nonzero(act.any(0))[0]},
                    "top1": []}
            state["call"] = call
            try:
                return real[2](self, h_rows, layer_active, offset, *a, **k)
            finally:
                state["call"] = None
                calls.append(call)

        moe_mod.router_topk = router
        GeoServingSystem._prefill_group_round = group_round
        BlockServer.prefill_rows = prefill_rows
        try:
            rec = S.group_serve(torch, tag, cfg, params, problem, **kw)
        finally:
            (moe_mod.router_topk, GeoServingSystem._prefill_group_round,
             BlockServer.prefill_rows) = real
        del rec["system"]
        gc.collect()
        torch.cuda.empty_cache()
        return rec, calls

    def per_layer(call, group):
        """The call's top-1 choices per layer, (rows, T) each."""
        n, T = call["shape"]
        top1 = call["top1"]
        if not group:
            return [t.reshape(n, T) for t in top1]
        out = []
        for lay in range(len(top1) // n_slots):
            g = top1[n_slots * lay:n_slots * (lay + 1)]
            if g[0].numel() * n_data == n * T:  # rows split over data
                out.append(torch.cat(g[::n_slots // n_data]).reshape(n, T))
            else:
                out.append(g[0].reshape(n, T))
        return out

    for cf in (base.capacity_factor, base.n_experts / base.moe_top_k):
        cfg = base.replace(capacity_factor=cf)
        problem = S.serve_problem(C, cfg.name, cfg.n_layers)
        tag = f"[routing cf {cf:g}]"
        solo, c_solo = serve(f"{tag} solo", cfg, problem)
        grp, c_grp = serve(f"{tag} (4, 2) group", cfg, problem, mesh=mesh)
        S.compare_first_steps(tag, solo, grp, strict=False)
        if len(c_solo) != len(c_grp):
            raise RuntimeError(f"{tag}: {len(c_solo)} solo prefill calls, "
                               f"{len(c_grp)} group calls")
        flips, n_tok = 0, 0
        last = {}  # prompt -> layers where its last token's expert differs
        moved = {}  # prompt -> its prompt tokens whose expert differs
        for a, b in zip(c_solo, c_grp):
            if a["shape"] != b["shape"] or a["offset"] != b["offset"] or \
                    set(a["rows"]) != set(b["rows"]):
                raise RuntimeError(f"{tag}: the runs' prefill calls differ")
            la, lb = per_layer(a, False), per_layer(b, True)
            for lay, (x, y) in enumerate(zip(la, lb)):
                diff = (x != y).cpu().numpy()
                for r, s in a["rows"].items():
                    if not a["active"][lay, r]:  # the row skips the layer
                        continue
                    key = tuple(int(t) for t in s.tokens[:s.prompt_len])
                    span = min(s.prompt_len - a["offset"], x.shape[1])
                    flips += int(diff[r, :span].sum())
                    n_tok += span
                    moved.setdefault(key, np.zeros(s.prompt_len, bool))
                    moved[key][a["offset"]:a["offset"] + span] |= \
                        diff[r, :span]
                    i = s.prompt_len - 1 - a["offset"]
                    if 0 <= i < span and diff[r, i]:
                        last.setdefault(key, []).append(
                            a["first_layer"] + lay)
        S.log(f"{tag} prompt tokens' top-1 experts that differ between the "
              f"runs: {flips} of {n_tok} (token, layer) choices")
        for q, (key, (_, l_s), (_, l_g)) in enumerate(
                zip(solo["prompts"], solo["first"], grp["first"])):
            d = float((l_g - l_s).abs().max()) / float(l_s.abs().max())
            S.log(f"{tag} request {q}: {len(key)} prompt tokens, first-step "
                  f"logits {d:.4f} of the solo scale apart; its last "
                  f"token's expert differs at layers {last.get(key, [])}; "
                  f"{int(moved.get(key, np.zeros(1, bool)).sum())} of its "
                  f"prompt tokens took another expert at some layer")
        del solo, grp
    return 0


if __name__ == "__main__":
    sys.exit(main())
