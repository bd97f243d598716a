"""Model layer of the port: the LM decode half (``transformer``), the BST
recsys model (``bst``), the four GNNs (``gnn``), shared blocks
(``common``) and the bridge from the reference's parameter trees
(``params``)."""
