# forge3d_tpu_torch/io: host copies of the JAX package's image writers.
