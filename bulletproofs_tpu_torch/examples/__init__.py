"""The JAX package's examples/, ported: each a module with a `main(...)`
that takes the JAX script's arguments and `device=` ("cuda" by default,
which needs a card; "cpu" runs the kernels' plain PyTorch versions).

    python -m bulletproofs_tpu_torch.examples.range_proof [--device cuda]
    python -m bulletproofs_tpu_torch.examples.mpc_aggregation
    python -m bulletproofs_tpu_torch.examples.mpc_multiprocess [m]
    python -m bulletproofs_tpu_torch.examples.r1cs_gadget [k]
    python -m bulletproofs_tpu_torch.examples.batch_throughput [batch]
"""
