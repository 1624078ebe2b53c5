"""The paper's experiment configurations (the ported slice)."""
