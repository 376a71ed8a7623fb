"""The LM scaffolding's models: config schema (`config`), building blocks
(`layers`), the dense decoder LM (`lm`) and the factory (`model`)."""
