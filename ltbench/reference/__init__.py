"""The plain reference of the benchmark's configurations: PyTorch
operations only, run in float32 with TF32 off (or, as the control, in a
lower precision).  It imports nothing of ``light_transport_tpu_torch``,
of ``light_transport_tpu`` or of JAX, and takes nothing the program
built: it works the scene's tables, the camera rays and every hit out
again from the configuration's triangles."""
