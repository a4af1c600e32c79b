"""The reference's side of ``tests/test_torch_collectives.py``, run as a
child process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
in the child's environment only (never this file's importer's
``os.environ``; ``repro.launch.dryrun`` is never imported: it sets
``XLA_FLAGS`` at import).

``python tests/_torch_collectives_ref.py`` compiles each program with
``jax.jit`` and ``NamedSharding``s on a (2, 2) ``("data", "model")`` mesh of
forced host devices and prints one line ``REF <json>``: each program's
collectives as ``repro.utils.hlo.parse_collectives`` reads them from the
compiled HLO.  The programs (``PRIMITIVES``) and the prefill cells
(``CELLS``, at ``CELL_SHAPE``) are the test's own.
"""
import json
import sys

import numpy as np

# name -> (in shapes, in specs, out spec); f32 throughout
PRIMITIVES = {
    # h (8, 256) @ w (256, 64), the contraction over ``model``
    "row_to_replicated": ([(8, 256), (256, 64)],
                          [(None, "model"), ("model", None)], (None, None)),
    "row_to_sharded": ([(8, 256), (256, 64)],
                       [(None, "model"), ("model", None)], (None, "model")),
    # x (8, 256) sharded on its columns, made whole
    "shard_to_replicate": ([(8, 256)], [(None, "model")], (None, None)),
    # x (8, 256): (data, model) -> (model, data)
    "transpose_layout": ([(8, 256)], [("data", "model")], ("model", "data")),
    # relu(x @ a) @ b: column-parallel a, row-parallel b
    "column_row_mlp": ([(8, 256), (256, 512), (512, 256)],
                       [(None, None), (None, "model"), ("model", None)],
                       (None, None)),
}
# the prefill cells: a dense and an MoE reduced config, at a small shape
CELLS = ("codeqwen1.5-7b", "olmoe-1b-7b")
CELL_SHAPE = ("prefill_cell", 16, 4)  # (name, seq_len, global_batch)


def _program(name):
    import jax
    import jax.numpy as jnp

    if name.startswith("row_"):
        return lambda h, w: h @ w
    if name == "column_row_mlp":
        return lambda x, a, b: jax.nn.relu(x @ a) @ b
    return lambda x: x * 1.0 if name == "shard_to_replicate" else jnp.copy(x)


def main():
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import SHAPES, ShapeSpec, get_config
    from repro.launch.specs import (abstract_train_state, input_specs,
                                    state_shardings)
    from repro.models import prefill
    from repro.sharding import use_mesh_rules
    from repro.utils.hlo import parse_collectives

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for name, (shapes, in_specs, out_spec) in PRIMITIVES.items():
        args = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
        fn = jax.jit(_program(name),
                     in_shardings=tuple(NamedSharding(mesh, P(*s))
                                        for s in in_specs),
                     out_shardings=NamedSharding(mesh, P(*out_spec)))
        out[name] = parse_collectives(fn.lower(*args).compile().as_text())

    cell, seq, batch = CELL_SHAPE
    SHAPES[cell] = ShapeSpec(cell, seq, batch, "prefill")
    for arch in CELLS:
        cfg = get_config(arch).reduced()
        spec = input_specs(cfg, cell)
        with mesh, use_mesh_rules(mesh):
            params = abstract_train_state(cfg, spec["opt_config"])["params"]
            p_sh = state_shardings({"params": params}, mesh)["params"]

            def prefill_fn(params, tokens, extras):
                return prefill(params, cfg, tokens,
                               prefix_embeds=extras.get("prefix_embeds"),
                               enc_frames=extras.get("enc_frames"))

            fn = jax.jit(prefill_fn,
                         in_shardings=(p_sh,) + spec["shardings"](mesh))
            text = fn.lower(params, *spec["args"]).compile().as_text()
        out[arch] = parse_collectives(text)
    print("REF " + json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
