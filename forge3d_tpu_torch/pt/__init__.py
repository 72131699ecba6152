# forge3d_tpu_torch/pt: path tracers of the port. Modules are imported by
# name; nothing is loaded here.
