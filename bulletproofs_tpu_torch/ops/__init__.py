"""Device code of the port: limb codecs and plain PyTorch arithmetic
(limbs, field, scalar, curve) and the wrappers of the CUDA kernels in
../csrc (curve.decompress, verify.emit, msm.accumulate / reduce / horner),
each beside its plain PyTorch version.  Importing builds nothing."""
