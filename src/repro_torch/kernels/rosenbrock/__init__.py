"""The fused Rosenbrock stiff ensemble kernel: binding and plain version
(`kernel`) and public entry (`ops`)."""
