"""Model configurations: the paper's detector (`yolo_irc`) and the ten
language-model architectures of the reference's zoo, value for value.

``registry.get_config(arch_id, variant)`` resolves ``--arch`` flags;
``shapes.SHAPES`` holds the assigned input shapes.
"""
