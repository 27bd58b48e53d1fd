"""Multi-device rendering over a mesh of torch devices: the mesh, the
static halo bound, the input-sharded (halo) and replicated-input (shard)
renders."""
