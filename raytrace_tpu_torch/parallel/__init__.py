"""Multi-device meshes, the process group and their collectives."""
