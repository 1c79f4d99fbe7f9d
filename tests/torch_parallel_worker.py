"""The rank programs of the two-rank tests (tests/test_torch_parallel*.py):

    python -m tests.torch_parallel_worker <case> <rank> <world> <port> <dir>

Each rank joins a gloo world on 127.0.0.1:<port> (with a timeout, so a
lost peer fails the run instead of hanging it), reads ``<dir>/inputs.pt``
(written by the test), runs ``<case>`` on the CPU on one thread, writes
``<dir>/out<rank>.pt`` and leaves the group. Imports torch and the port
only.
"""
import datetime
import os
import sys

import torch
import torch.distributed as dist

TIMEOUT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """An OS-assigned free port (a fixed one can linger in TIME_WAIT)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case, d, inputs, world=2, timeout=120):
    """Write ``inputs`` to ``d``, run ``case`` on ``world`` ranks (one
    process each) and return their outputs in rank order. Every rank is
    killed when one outlives ``timeout`` seconds; a rank that fails fails
    the call with its output."""
    import subprocess

    os.makedirs(d, exist_ok=True)
    port = free_port()
    inputs = dict(inputs, coordinator=f"127.0.0.1:{port}")
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    # each rank's output goes to a file: a full pipe would stall a rank
    # inside a collective while its peer is being waited on
    logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", case, str(r),
                               str(world), str(port), str(d)], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs:
            p.communicate(timeout=timeout)
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(d, f"log{r}.txt")) as f:
            assert p.returncode == 0, f"rank {r} of {case} failed:\n{f.read()[-4000:]}"
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _inputs(d):
    return torch.load(os.path.join(d, "inputs.pt"), weights_only=False)


def _save(d, r, out):
    torch.save(out, os.path.join(d, f"out{r}.pt"))


def ddp_steps(r, w, d):
    """Trainer.train_step under data_group=WORLD: each config of
    ``inputs["runs"]`` trains on this rank's rows of every call's global
    batch and draws; returns per call the metrics and, after the last,
    the trainable leaves."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.parallel import shard_batch
    from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer

    inp = _inputs(d)
    eng = Engine(inp["engine_cfg"], device="cpu")
    out = []
    for run in inp["runs"]:
        tr = Trainer(eng, TrainConfig(**run["train_cfg"]), data_group=dist.group.WORLD)
        state = tr.init_state(inp["params"])._replace(step=1)
        metrics = []
        for batch, draws in run["calls"]:
            state, m = tr.train_step(state, shard_batch(batch),
                                     Draws(torch.Generator().manual_seed(0),
                                           shard_batch(draws)))
            metrics.append({k: float(v) for k, v in m.items()})
        out.append({"metrics": metrics,
                    "trainable": [leaf.detach().clone() for leaf in tr.trainable(state)]})
    _save(d, r, out)


def train_cli(r, w, d):
    """cli.train.main --smoke --multihost on the CPU, each rank writing
    under its own output directory."""
    from custom_diffusion360_torch.cli import train as cli
    from custom_diffusion360_torch.parallel import mesh

    mesh.DEFAULT_TIMEOUT_S = TIMEOUT_S  # the CLI's rendezvous and collectives
    inp = _inputs(d)
    out_dir = os.path.join(d, f"run{r}")
    summary = cli.main(["--smoke", "--multihost", "--coordinator", inp["coordinator"],
                        "--num_processes", str(w), "--process_id", str(r), "--device", "cpu",
                        "--output_dir", out_dir, "--accumulate", "2", "--smoke_steps", "3",
                        "--full_ckpt_every", "2", "--val_every", "2", "--log_every", "1"])
    _save(d, r, {"trainable": summary["trainable"], "delta": summary["delta"],
                 "steps": len(summary["steps"])})


def capture(r, w, d):
    """capture_references over view_group=WORLD."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.train.capture import capture_references

    inp = _inputs(d)
    eng = Engine(inp["engine_cfg"], device="cpu")
    refs = capture_references(eng, inp["params"], inp["images"], inp["cams"], inp["cond"],
                              Draws(torch.Generator().manual_seed(inp["seed"])),
                              view_group=dist.group.WORLD)
    _save(d, r, refs)


def cfg_sample(r, w, d):
    """Engine.sample with cfg_group=WORLD."""
    from custom_diffusion360_torch.engine import Engine

    inp = _inputs(d)
    eng = Engine(inp["engine_cfg"], device="cpu")
    z = eng.sample(inp["params"], inp["cond"], inp["uc"], inp["guider"], noise=inp["noise"],
                   cams=inp["cams"], references=inp["references"], choices=inp["choices"],
                   num_steps=inp["steps"], shared_target_cams=True, cfg_group=dist.group.WORLD,
                   **inp.get("kwargs", {}))
    _save(d, r, z)


def sample_cli(r, w, d):
    """cli.sample.main --latency_shard with torchrun's environment set, each
    rank writing under its own output directory."""
    from custom_diffusion360_torch.cli import sample as cli
    from custom_diffusion360_torch.parallel import mesh

    mesh.DEFAULT_TIMEOUT_S = TIMEOUT_S
    host, port = _inputs(d)["coordinator"].split(":")
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(r), WORLD_SIZE=str(w))
    (rec,) = cli.main(_inputs(d)["argv"] + ["--latency_shard", "--output_dir",
                                           os.path.join(d, f"out_dir{r}")])
    _save(d, r, {"images": rec["images"], "paths": rec["paths"]})


def tp_sample(r, w, d):
    """Engine.sample on this rank's tensor-parallel slices, the world as the
    model group."""
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.parallel import shard_params_tp, tensor_parallel

    inp = _inputs(d)
    eng = Engine(inp["engine_cfg"], device="cpu")
    params = shard_params_tp(inp["params"], w, r)
    with tensor_parallel(dist.group.WORLD):
        z = eng.sample(params, inp["cond"], inp["cond"], inp["guider"], noise=inp["noise"],
                       cams=inp["cams"], references=inp["references"], choices=inp["choices"],
                       num_steps=inp["steps"])
    _save(d, r, {"z": z, "q_cols": params["unet"]["input_blocks"][4][1]["blocks"][0]
                 ["attn1"]["to_q"]["w"].shape[1]})


def tp_loss(r, w, d):
    """Engine.training_loss on tensor-parallel slices, the world as the
    model group, and the gradients of the trainable leaves."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.parallel import shard_params_tp, tensor_parallel
    from custom_diffusion360_torch.train.trainer import Trainer

    inp = _inputs(d)
    eng = Engine(inp["engine_cfg"], device="cpu")
    tr = Trainer(eng)
    state = tr.init_state(shard_params_tp(inp["params"], w, r))
    with tensor_parallel(dist.group.WORLD):
        loss, metrics = eng.training_loss(state.params, inp["batch"], 1,
                                          Draws(torch.Generator().manual_seed(0), inp["draws"]))
        loss.backward()
    _save(d, r, {"metrics": {k: float(v) for k, v in metrics.items()},
                 "model_size": dist.get_world_size(),
                 "grads": [leaf.grad.clone() for leaf in tr.trainable(state)]})


CASES = {f.__name__: f for f in (ddp_steps, train_cli, capture, cfg_sample, sample_cli,
                                 tp_sample, tp_loss)}


def main(argv):
    case, r, w, port, d = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    if case not in ("train_cli", "sample_cli"):  # the CLIs join the world themselves
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=r,
                                world_size=w, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        CASES[case](r, w, d)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
