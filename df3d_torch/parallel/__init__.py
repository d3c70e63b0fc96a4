"""Data parallelism over processes (port of df3d/parallel/mesh.py): see
`ddp`."""
