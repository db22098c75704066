"""Multi-device scaling: device meshes, frame-batch sharding, host streaming."""
