"""Plain float32 references, one module per model family (named by the
family a configuration file gives), plus the pieces they share: the
coded rows' weights (`coding`) and the update rules (`updates`). Nothing
here imports the program."""
