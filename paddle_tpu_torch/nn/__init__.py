"""nn APIs of the port (the functional ops the LLaMA forward routes)."""
