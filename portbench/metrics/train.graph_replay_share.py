"""Share of the process's training steps on the card that replayed CUDA
graphs (``train/train_graphs.py``'s counter), over those that replayed or
ran eagerly, %; None where the program has no such counter or counted
nothing (the CPU)."""
import importlib

COUNTER = ("custom_diffusion360_torch.train.train_graphs", "steps")


def read(ctx):
    module, name = COUNTER
    try:
        counts = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError):
        return None
    replay, eager = counts.get("replay", 0), counts.get("eager", 0)
    if replay + eager == 0:
        return None
    return 100.0 * replay / (replay + eager)
