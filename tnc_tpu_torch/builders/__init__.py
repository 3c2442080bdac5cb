"""Circuit and network builders."""
