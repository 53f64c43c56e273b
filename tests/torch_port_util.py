"""Shared weights for the port's comparison tests (tests/test_torch_port_*).

The port's seeded `tiny` init is written out as a flax parameter tree (numpy),
and both sides are built from that one tree: the JAX `DiffusionModel` takes
it as its params, and the port loads it back through `from_jax_params`.  This
skips the JAX preset's jitted init, which costs tens of seconds per process.
"""

import functools

import torch.nn as nn


def flax_tree(nets: nn.Module) -> dict:
    """Port modules -> nested flax param tree of numpy arrays (the inverse of
    eta_inversion_tpu_torch.models.convert.from_jax_params)."""
    tree: dict = {}
    for name, mod in nets.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        for pname, p in own.items():
            a = p.detach().float().cpu().numpy()
            if pname == "weight":
                if isinstance(mod, nn.Conv2d):
                    node["kernel"] = a.transpose(2, 3, 1, 0)
                elif isinstance(mod, nn.Linear):
                    node["kernel"] = a.T
                elif isinstance(mod, nn.Embedding):
                    node["embedding"] = a
                else:  # norms
                    node["scale"] = a
            else:
                node[pname] = a
    return tree


@functools.lru_cache(maxsize=1)
def tiny_pair(seed: int = 0):
    """(JAX tiny DiffusionModel, port tiny DiffusionModel) with equal weights,
    fp32, on the CPU."""
    from eta_inversion_tpu.models import TINY, DiffusionModel as JaxModel
    from eta_inversion_tpu.models.tokenizer import load_tokenizer
    from eta_inversion_tpu_torch.models import load_diffusion_model

    port, _ = load_diffusion_model("tiny", seed=seed, device="cpu")
    tree = flax_tree(port.nets)
    port.load_jax_params(tree)  # weights reach the port through from_jax_params
    jax_model = JaxModel(TINY, tree, load_tokenizer(None, vocab_size=TINY.text.vocab_size))
    return jax_model, port
