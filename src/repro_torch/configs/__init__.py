"""Model and input-shape configs: copies of the reference's, which import
no framework.  ``registry.get_config(arch_id)`` resolves them by name."""
