"""The int8 ring's greedy agreement with float32 collectives at GPT-2-small
width: the JAX package's mesh engine against the port's, on the CPU.

`chip_smoke.py` phase 15 serves its traffic at tp 4 on int8 pools twice,
with float32 all-reduces and with the quantized ring, and reads how many
greedy tokens the two runs share.  This script serves the same pair on
the JAX package's mesh engine (`tp_mesh(4)` over forced host devices) and
on the port's CPU mesh engine, with the same weights (the JAX model's,
carried across) and the phase's prompts and engine, at a cut depth, and
prints each package's position-wise agreement and whether the two
packages' streams are token-identical.  Every request is greedy: the two
packages' samplers differ in their last bits at this vocabulary, and the
ring's chunk scales see every row of a step.

    JAX_PLATFORMS=cpu python tests/torch_tp_ring_agreement.py --layers 4
"""
import argparse
import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu import generation as jgen  # noqa: E402
from paddle_tpu.parallel import tp_mesh as jax_tp_mesh  # noqa: E402
from paddle_tpu_torch import generation as pgen  # noqa: E402
from paddle_tpu_torch.parallel import tp_mesh  # noqa: E402

TP = chip_smoke.TP_MAIN
CHUNK = 64


def serve(pkg, model, cfg, prompts, new):
    eng = pkg.GenerationEngine(model, pkg.GenerationConfig(
        **chip_smoke.ENGINE, prefill_chunk_tokens=CHUNK, kv_dtype="int8",
        **cfg), start=False)
    handles = [eng.submit(p, max_new_tokens=new,
                          sampling=pkg.SamplingParams()) for p in prompts]
    eng.run_until_idle()
    toks = [h.result(timeout=60).token_ids for h in handles]
    snap = eng.stats()
    eng.shutdown()
    return toks, snap["generation.collective_bytes_per_step"]


def agreement(a, b):
    total = sum(max(len(x), len(y)) for x, y in zip(a, b))
    match = sum(p == q for x, y in zip(a, b) for p, q in zip(x, y))
    return match, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--new", type=int, default=chip_smoke.MAX_NEW)
    ap.add_argument("--traffic-seed", type=int, default=1,
                    help="the prompts' seed (1: the phase's)")
    args = ap.parse_args()
    spec = {**chip_smoke.MODEL, "num_layers": args.layers}
    jmodel = jgen.TinyCausalLM(**spec)
    tree = {k: np.asarray(v) if not isinstance(v, list) else
            [{n: np.asarray(a) for n, a in b.items()} for b in v]
            for k, v in jmodel.decode_params().items()}
    pmodel = pgen.TinyCausalLM.from_numpy_params(
        tree, num_heads=spec["num_heads"], seed=spec["seed"], device="cpu")
    prompts = chip_smoke.traffic(np.random.default_rng(args.traffic_seed))
    runs = {}
    for quant in (False, True):
        t0 = time.perf_counter()
        runs["jax", quant] = serve(
            jgen, jmodel, dict(kv_backend="device", step_mode="ragged",
                               mesh=jax_tp_mesh(TP),
                               quantized_collectives=quant),
            prompts, args.new)
        runs["port", quant] = serve(
            pgen, pmodel, dict(mesh=tp_mesh(TP, devices=["cpu"] * TP),
                               quantized_collectives=quant),
            prompts, args.new)
        print(f"quantized_collectives={quant}: both packages in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = dict(layers=args.layers, traffic_seed=args.traffic_seed, tp=TP,
               requests=len(prompts),
               new_tokens=args.new)
    for pkg in ("jax", "port"):
        match, total = agreement(runs[pkg, False][0], runs[pkg, True][0])
        out[pkg] = dict(agreement=f"{match}/{total}",
                        share=match / total,
                        bytes_per_step=[runs[pkg, False][1],
                                        runs[pkg, True][1]])
    for quant in (False, True):
        out[f"token_identical_quant_{quant}"] = (
            runs["jax", quant][0] == runs["port", quant][0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
