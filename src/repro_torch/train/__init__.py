"""Step factories of the LM scaffolding: training (`trainer`) and serving
(`serve`)."""
