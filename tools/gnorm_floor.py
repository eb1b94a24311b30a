"""Spread of the kernels-vs-plain gradient-norm difference of chip_smoke.py's
ASR train step, packed (--pack) and unpacked, over perturbations of the
parameters by about one fp32 rounding (1e-7 relative): how far rounding
alone moves the norm that chip_smoke.compare_plain_step compares.  Needs
the card; from the repository root:

    python3 tools/gnorm_floor.py

Prints the card's name and power limit, then one JSON line per (batch,
perturbation seed; seed 0 unperturbed).
"""
import contextlib
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.gpu_name_and_power_limit(), flush=True)
    batch = cs.asr_batch(dev)
    args = cli.parse_args(cs.ASR_ARGS + ["--pack"])
    model = cli.build_model(args, cs.ASR_VOCAB, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    packed = {k: torch.as_tensor(v, device=dev) for k, v in
              cli.attach_pack_plan(dict(batch), model, {}).items()}
    state = create_train_state(model, optim_cfg)
    grad_step, _ = make_accum_train_step(loss_fn, optim_cfg)

    def grads(b, noise_seed, plain):
        """Every parameter's gradient (float64) at dropout 0, from the
        parameters scaled by (1 + 1e-7 N(0, 1)) unless noise_seed is 0."""
        st = copy.deepcopy(state)
        if noise_seed:
            gen = torch.Generator(device=dev)
            gen.manual_seed(noise_seed)
            with torch.no_grad():
                for p in st.model.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                                  device=dev))
        with cs.plain_training() if plain else contextlib.nullcontext():
            grad_step(st, b, None)
        return {n: p.grad.double().clone()
                for n, p in st.model.named_parameters()}

    def gnorm(g):
        return float(torch.sqrt(sum((v ** 2).sum() for v in g.values())))

    for name, b in (("unpacked", batch), ("packed", packed)):
        gn_ref = gnorm(grads(b, 0, True))
        for seed in range(4):
            gk, gp = grads(b, seed, False), grads(b, seed, True)
            # each parameter's share of the norm's difference
            top = sorted(((n, float(((gk[n] - gp[n]) * gp[n]).sum())
                           / gnorm(gp)) for n in gk),
                         key=lambda kv: -abs(kv[1]))[:4]
            rel = max(float((gk[n] - gp[n]).abs().max()) / cs.grad_scale(gp, n)
                      for n in gk)
            print(json.dumps({
                "batch": name, "noise_seed": seed,
                "gnorm_kernel": gnorm(gk), "gnorm_plain": gnorm(gp),
                "k_vs_p_gnorm_rel": (gnorm(gk) - gnorm(gp)) / gnorm(gp),
                "plain_vs_unperturbed_plain_rel": (gnorm(gp) - gn_ref)
                / gn_ref,
                "grads_max_err_to_largest": rel,
                "gnorm_delta_by_param": top}), flush=True)


if __name__ == "__main__":
    main()
