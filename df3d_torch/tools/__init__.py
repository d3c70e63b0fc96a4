"""The port's command-line tools (the JAX package's tools/): `python -m
df3d_torch.tools.train`, `.test`, `.create_data`, `.demo` and
`.fit_caps`."""
