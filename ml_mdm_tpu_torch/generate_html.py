"""The HTML gallery of ``generate_batch``'s samples.

Counterpart of ``ml_mdm_tpu/generate_html.py``: ``create_html`` writes a
page of the images with their captions, ``create_css`` its style sheet.
"""
import html
import os


def create_html(tgt_file, num_items, caption_lst):
    parts = [
        """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="UTF-8">
<meta name="viewport" content="width=device-width, initial-scale=1.0">
<link rel="stylesheet" href="/css/style.css">
<title>Sample Gallery</title>
</head>
<body><div class="container"><div class="gallery">
"""
    ]
    for item_num in range(min(num_items, len(caption_lst))):
        caption = html.escape(caption_lst[item_num][1], quote=True)
        fname = os.path.basename(caption_lst[item_num][0])
        parts.append(
            f'<figure class="gallery__item">'
            f'<img src="rank0/{fname}" onclick="showText(\'{caption}\')" '
            f'class="gallery__img"></figure>\n'
        )
    parts.append(
        """</div></div>
<div id="caption" class="center">Caption</div>
</body></html>
<script language="JavaScript">
function showText(text){document.getElementById("caption").innerText = text;}
</script>
"""
    )
    with open(tgt_file, "w") as f:
        f.write("".join(parts))


def create_css(fname):
    contents = """
*,*::after,*::before{margin:0;padding:0;box-sizing:inherit;}
.center{border:5px solid;margin:auto;width:100%;padding:0;font-size:large;
text-align:center}
html{box-sizing:border-box;font-size:62.5%;}
body{font-family:"Nunito",sans-serif;color:#333;font-weight:300;
line-height:1.6;}
.container{width:100%;margin:0.1rem auto;}
.gallery{display:grid;
grid-template-columns:repeat(auto-fit,minmax(64px,1fr));
grid-auto-rows:64px;gap:0.2rem;}
.gallery__img{width:100%;height:100%;object-fit:contain;display:block;}
"""
    with open(fname, "w") as f:
        f.write(contents)
