"""ResNet in dygraph, built from either package's ``dygraph.nn`` layers
(``Conv2D`` / ``BatchNorm`` / ``Pool2D`` / ``FC``) in the structure and
with the parameter names of ``models/resnet.py``'s static program
(``stem.conv.w``, ``res0_0.b0.bn.scale``, ``fc_out.w``, ...), so a static
startup's values load into it by name (:func:`load_static`).

``chip_smoke.py``'s ``dygraph_train`` and
``tests/test_torch_dygraph_resnet.py`` use it::

    net = build_resnet(paddle_tpu_torch, depth=50, class_dim=1000)
    load_static(dygraph, net, {name: array}, (3, 224, 224))
    loss = loss_of(dygraph, net, image_var, label_var)
"""

#: bottleneck blocks a stage by depth (``models/resnet.py``'s)
_BLOCKS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def build_resnet(pkg, depth=50, class_dim=1000, channels=3):
    """A bottleneck ResNet of ``pkg``'s dygraph layers (``pkg`` is
    ``paddle_tpu`` or ``paddle_tpu_torch``), in a dygraph guard."""
    dy, nn, ParamAttr = pkg.dygraph, pkg.dygraph.nn, pkg.ParamAttr

    class ConvBN(dy.Layer):
        """``conv_bn_layer``: a conv without bias, then batch norm."""

        def __init__(self, cin, nf, fs, stride=1, act=None, name=None):
            super().__init__(name)
            self.bn_name = f"{name}.bn"
            self.conv = nn.Conv2D(None, cin, nf, fs, stride=stride,
                                  padding=(fs - 1) // 2,
                                  param_attr=ParamAttr(name=f"{name}.conv.w"),
                                  bias_attr=False)
            self.bn = nn.BatchNorm(None, nf, act=act,
                                   param_attr=ParamAttr(
                                       name=f"{name}.bn.scale"),
                                   bias_attr=ParamAttr(
                                       name=f"{name}.bn.offset"))

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(dy.Layer):
        def __init__(self, cin, nf, stride, name):
            super().__init__(name)
            self.b0 = ConvBN(cin, nf, 1, act="relu", name=f"{name}.b0")
            self.b1 = ConvBN(nf, nf, 3, stride, act="relu",
                             name=f"{name}.b1")
            self.b2 = ConvBN(nf, nf * 4, 1, name=f"{name}.b2")
            self.short = ConvBN(cin, nf * 4, 1, stride,
                                name=f"{name}.short") \
                if cin != nf * 4 or stride != 1 else None

        def forward(self, x):
            y = self.b2(self.b1(self.b0(x)))
            s = self.short(x) if self.short is not None else x
            return dy.default_tracer().trace_op(
                "relu", {"X": [s + y]}, {})["Out"][0]

    class ResNet(dy.Layer):
        def __init__(self):
            super().__init__("resnet")
            self.stem = ConvBN(channels, 64, 7, 2, act="relu", name="stem")
            self.pool = nn.Pool2D(None, pool_size=3, pool_type="max",
                                  pool_stride=2, pool_padding=1)
            blocks, cin = [], 64
            for stage, (nf, cnt) in enumerate(zip([64, 128, 256, 512],
                                                  _BLOCKS[depth])):
                for blk in range(cnt):
                    stride = 2 if blk == 0 and stage > 0 else 1
                    b = Bottleneck(cin, nf, stride, f"res{stage}_{blk}")
                    self.add_sublayer(f"res{stage}_{blk}", b)
                    blocks.append(b)
                    cin = nf * 4
            self.blocks = blocks
            self.gap = nn.Pool2D(None, pool_type="avg", global_pooling=True)
            self.fc = nn.FC(None, size=class_dim, act="softmax",
                            param_attr=ParamAttr(name="fc_out.w"),
                            bias_attr=ParamAttr(name="fc_out.b"))

        def forward(self, x):
            h = self.pool(self.stem(x))
            for b in self.blocks:
                h = b(h)
            return self.fc(self.gap(h))

    return ResNet()


def conv_bns(net):
    """The net's conv + BN sublayers."""
    return [l for l in net.sublayers() if hasattr(l, "bn_name")]


def load_static(dy, net, values, image_shape):
    """Load a static startup's ``{name: array}`` into ``net`` by parameter
    name, the BN running statistics from ``<name>.bn.mean`` / ``.var``.
    The ``FC`` builds its weight on its first forward, so a zero image of
    ``image_shape`` runs through the net first (without the tape)."""
    import numpy as np
    with dy.no_grad():
        net(dy.to_variable(np.zeros((1,) + tuple(image_shape), np.float32)))
    for l in conv_bns(net):
        l.bn._mean.set_value(values[l.bn_name + ".mean"])
        l.bn._variance.set_value(values[l.bn_name + ".var"])
    for p in net.parameters():
        p.set_value(values[p.name])


def loss_of(dy, net, image, label):
    """``mean(cross_entropy(net(image), label))``, as the static program
    computes it."""
    t = dy.default_tracer()
    ce = t.trace_op("cross_entropy", {"X": [net(image)], "Label": [label]},
                    {"soft_label": False, "ignore_index": -100})["Y"][0]
    return t.trace_op("mean", {"X": [ce]}, {})["Out"][0]
