"""Launchers: the process group (`mesh`), the ensemble-solve entry
(`solve`) and the LM training entry (`train`)."""
