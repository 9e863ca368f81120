"""ResNet family (the port's ``paddle_tpu/models/resnet.py``; ref fluid
image_classification recipe).  Same layers, names and op descs as the
reference, so both packages build the same training program: ResNet
(``resnet``, ``build_resnet_train``) and SE-ResNeXt (``se_resnext``,
``build_se_resnext_train``, ref ``resnet.py:134-196``).
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False,
                  use_global_stats=False):
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False,
                         param_attr=ParamAttr(name=f"{name}.conv.w"))
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             param_attr=ParamAttr(name=f"{name}.bn.scale"),
                             bias_attr=ParamAttr(name=f"{name}.bn.offset"),
                             moving_mean_name=f"{name}.bn.mean",
                             moving_variance_name=f"{name}.bn.var",
                             use_global_stats=use_global_stats)


def shortcut(input, ch_out, stride, name, is_test=False,
             use_global_stats=False):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test,
                             use_global_stats=use_global_stats)
    return input


def bottleneck_block(input, num_filters, stride, name, is_test=False,
                     use_global_stats=False):
    ugs = use_global_stats
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=f"{name}.b0", is_test=is_test,
                          use_global_stats=ugs)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=f"{name}.b1", is_test=is_test,
                          use_global_stats=ugs)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, name=f"{name}.b2",
                          is_test=is_test, use_global_stats=ugs)
    short = shortcut(input, num_filters * 4, stride, f"{name}.short",
                     is_test=is_test, use_global_stats=ugs)
    return layers.relu(short + conv2)


def basic_block(input, num_filters, stride, name, is_test=False,
                use_global_stats=False):
    ugs = use_global_stats
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          name=f"{name}.b0", is_test=is_test,
                          use_global_stats=ugs)
    conv1 = conv_bn_layer(conv0, num_filters, 3, name=f"{name}.b1",
                          is_test=is_test, use_global_stats=ugs)
    short = shortcut(input, num_filters, stride, f"{name}.short",
                     is_test=is_test, use_global_stats=ugs)
    return layers.relu(short + conv1)


_DEPTH_CFG = {
    18: (basic_block, [2, 2, 2, 2]),
    34: (basic_block, [3, 4, 6, 3]),
    50: (bottleneck_block, [3, 4, 6, 3]),
    101: (bottleneck_block, [3, 4, 23, 3]),
    152: (bottleneck_block, [3, 8, 36, 3]),
}


def space_to_depth_nchw(img, block=2):
    """Host-side space-to-depth for the s2d stem input pipeline (numpy,
    NCHW): [B,C,H,W] → [B,C·b²,H/b,W/b].  The TPU RN50 stem trick (used
    by public MLPerf ResNet submissions): blocking 2×2 spatial into
    channels turns the C_in=3 stem conv — which fills 3 of the MXU's 128
    lanes — into a C_in=12 conv at a quarter the spatial size."""
    b, c, h, w = img.shape
    out = img.reshape(b, c, h // block, block, w // block, block)
    out = out.transpose(0, 1, 3, 5, 2, 4)
    return out.reshape(b, c * block * block, h // block, w // block)


def resnet(input, class_dim=1000, depth=50, is_test=False, s2d_stem=False,
           use_global_stats=False):
    block_fn, counts = _DEPTH_CFG[depth]
    ugs = use_global_stats
    if s2d_stem:
        # input is the space-to-depth image [12,112,112]; a 3×3/s1 conv
        # here sees a 6×6 receptive field in the original image (vs the
        # 7×7/s2 stem) and produces the same [64,112,112] output — the
        # standard TPU reparameterization of the ResNet stem
        conv = conv_bn_layer(input, 64, 3, stride=1, act="relu",
                             name="stem", is_test=is_test,
                             use_global_stats=ugs)
    else:
        conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                             name="stem", is_test=is_test,
                             use_global_stats=ugs)
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1)
    filters = [64, 128, 256, 512]
    x = pool
    for stage, (nf, cnt) in enumerate(zip(filters, counts)):
        for blk in range(cnt):
            stride = 2 if blk == 0 and stage > 0 else 1
            x = block_fn(x, nf, stride, f"res{stage}_{blk}", is_test=is_test,
                         use_global_stats=ugs)
    pool = layers.pool2d(x, global_pooling=True, pool_type="avg")
    return layers.fc(pool, size=class_dim, act="softmax",
                     param_attr=ParamAttr(name="fc_out.w"),
                     bias_attr=ParamAttr(name="fc_out.b"))


def build_resnet_train(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                       is_test=False, s2d_stem=False, use_global_stats=False):
    if s2d_stem:
        c, h, w = image_shape
        image_shape = (c * 4, h // 2, w // 2)
    img = layers.data("image", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    pred = resnet(img, class_dim, depth, is_test=is_test, s2d_stem=s2d_stem,
                  use_global_stats=use_global_stats)
    cost = layers.cross_entropy(pred, label)
    avg_cost = layers.mean(cost)
    acc1 = layers.accuracy(pred, label, k=1)
    acc5 = layers.accuracy(pred, label, k=5)
    return (img, label), pred, avg_cost, (acc1, acc5)


# -- SE-ResNeXt (ref tests/unittests/dist_se_resnext.py SE_ResNeXt) ----------

def squeeze_excitation(input, num_channels, reduction_ratio, name,
                       is_test=False):
    """SE block: global-pool → bottleneck fc → sigmoid channel gates."""
    pool = layers.pool2d(input, global_pooling=True, pool_type="avg")
    squeeze = layers.fc(pool, size=num_channels // reduction_ratio,
                        act="relu",
                        param_attr=ParamAttr(name=f"{name}.sq.w"),
                        bias_attr=ParamAttr(name=f"{name}.sq.b"))
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid",
                           param_attr=ParamAttr(name=f"{name}.ex.w"),
                           bias_attr=ParamAttr(name=f"{name}.ex.b"))
    scale = layers.reshape(excitation, shape=[-1, num_channels, 1, 1])
    return input * scale


def se_bottleneck_block(input, num_filters, stride, cardinality,
                        reduction_ratio, name, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=f"{name}.b0", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu",
                          name=f"{name}.b1", is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, name=f"{name}.b2",
                          is_test=is_test)
    scaled = squeeze_excitation(conv2, num_filters * 2, reduction_ratio,
                                name=f"{name}.se", is_test=is_test)
    short = shortcut(input, num_filters * 2, stride, f"{name}.short",
                     is_test=is_test)
    return layers.relu(short + scaled)


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False):
    """SE-ResNeXt-{50,101,152} (ref dist_se_resnext.py net()); the head's
    dropout is 0.5, ``downgrade_in_infer``."""
    counts = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
              152: [3, 8, 36, 3]}[depth]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu",
                         name="se_stem", is_test=is_test)
    x = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1)
    filters = [128, 256, 512, 1024]
    for stage, (nf, cnt) in enumerate(zip(filters, counts)):
        for blk in range(cnt):
            stride = 2 if blk == 0 and stage > 0 else 1
            x = se_bottleneck_block(x, nf, stride, cardinality,
                                    reduction_ratio,
                                    f"se{stage}_{blk}", is_test=is_test)
    pool = layers.pool2d(x, global_pooling=True, pool_type="avg")
    drop = layers.dropout(pool, dropout_prob=0.5, is_test=is_test)
    return layers.fc(drop, size=class_dim, act="softmax",
                     param_attr=ParamAttr(name="se_fc_out.w"),
                     bias_attr=ParamAttr(name="se_fc_out.b"))


def build_se_resnext_train(class_dim=1000, depth=50,
                           image_shape=(3, 224, 224), is_test=False):
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    pred = se_resnext(img, class_dim=class_dim, depth=depth,
                      is_test=is_test)
    loss = layers.mean(layers.cross_entropy(pred, label))
    acc = layers.accuracy(pred, label)
    return loss, acc, [img, label]
