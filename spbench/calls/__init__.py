"""How each call kind of the operator is driven and what it should give,
one module a kind, named by a traffic mix's ``call``:

* ``operands(t, m, n, gen, device, dtype)``: the pool of inputs the
  window cycles through (``t`` the traffic mix, ``gen`` a
  ``torch.Generator``, ``dtype`` the matrix's value type);
* ``first_y(t, m, n, gen, device, dtype)``: the ``y`` of the first call,
  or None;
* ``invoke(op, t, x, y)``: one call;
* ``expect(ref, t, x, y)``: what that call should give, from the
  reference (``reference.Matrix``) alone.
"""
