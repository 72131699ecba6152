# forge3d_tpu_torch/ops: device operators of the port. Modules are imported
# by name; nothing is loaded here.
