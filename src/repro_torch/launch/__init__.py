"""Launchers: the process group (`mesh`) and the ensemble-solve entry
(`solve`)."""
